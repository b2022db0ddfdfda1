from repro_torch.serve.bucketing import BucketLadder
from repro_torch.serve.engine import (BucketedScorer, SwapRejected,
                                      combine_block)
