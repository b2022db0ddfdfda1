from repro_torch.configs.base import (ARCH_IDS, ArchConfig, get_config,
                                      get_reduced_config, replace)
