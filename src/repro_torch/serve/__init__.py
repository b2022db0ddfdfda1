"""Ensemble serving — the port's counterpart of ``repro.serve``.

* ``BucketLadder`` / ``BucketedScorer`` — bucketed batch shapes: one
  captured CUDA graph per bucket on the card, ever
  (``assert_compile_budget`` guards it), with pad-and-mask scoring where
  padded rows never vote.
* ``EnsembleServer`` / ``ServeConfig`` — request queue + continuous
  batching under a latency SLO (flush on max-batch OR max-wait).
* ``CheckpointWatcher`` — hot-reload: poll a training run's checkpoint
  dir, swap stacked weights between batches with zero dropped requests.
* ``run_open_loop`` / ``LoadReport`` — synthetic open-loop load with
  p50/p95/p99 + images/s reporting.
"""
from repro_torch.serve.bucketing import BucketLadder  # noqa: F401
from repro_torch.serve.engine import (BucketedScorer,  # noqa: F401
                                      CompileBudgetExceeded, SwapRejected,
                                      combine_block)
from repro_torch.serve.hot_reload import (CheckpointWatcher,  # noqa: F401
                                          SwapEvent)
from repro_torch.serve.loadgen import LoadReport, run_open_loop  # noqa: F401
from repro_torch.serve.scheduler import (EnsembleServer,  # noqa: F401
                                         QueueFull, ServeConfig, ServeResult,
                                         ServerStats)
