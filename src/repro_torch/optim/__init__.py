from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm, clip_scale,
                                          global_norm, momentum, sgd,
                                          step_leafwise)
from repro_torch.optim.schedules import (constant, cosine, dynamic_paper,
                                         linear_warmup, wsd)
