from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ArchConfig,
                                      InputShape, get_config,
                                      get_reduced_config, replace,
                                      supported_shapes)
