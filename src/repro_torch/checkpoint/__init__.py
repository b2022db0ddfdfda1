from repro_torch.checkpoint.ckpt import (latest_step, list_steps,
                                         restore_checkpoint, save_checkpoint)
