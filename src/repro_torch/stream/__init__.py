"""repro_torch.stream — the streaming Map phase with concept-drift
handling; the port's counterpart of ``repro.stream``.

* ``sources``  — ``StreamSource`` protocol + glob-pattern file streams,
  in-memory array streams and the synthetic drift generator; per-member
  shard streams follow THE ``seed + i`` rng rule.
* ``window``   — ``SlidingWindowStats``: a bounded deque of per-chunk
  ``ELMStats`` deltas on the run's device whose running total is
  rank-updated on push and rank-DOWNdated on evict
  (``elm.downdate_stats``), with an equivalence gate against
  recompute-from-scratch.
* ``drift``    — per-member held-out score tracked per chunk:
  ``DriftDetector`` (EWMA baseline, drop threshold) and
  ``PageHinkleyDetector`` (cumulative-deviation PH test), both behind
  ``make_detector`` / ``StreamConfig.drift_detector``.
* ``run``      — ``StreamingRun``: the chunk loop (prequential
  score → train block through the executor → window update → windowed β)
  plus the sync policies ``ReduceConfig(sync="rounds"|"drift")`` and
  per-sync checkpointing for ``repro_torch.serve`` hot-reload.
"""
from repro_torch.stream.drift import (DriftDetector,  # noqa: F401
                                      PageHinkleyDetector, make_detector)
from repro_torch.stream.run import (StreamConfig, StreamingRun,  # noqa: F401
                                    StreamRecord, StreamResult, SyncEvent)
from repro_torch.stream.sources import (ArraySource,  # noqa: F401
                                        FileSource, StreamSource,
                                        SyntheticDriftSource, member_streams,
                                        write_shard_files)
from repro_torch.stream.window import SlidingWindowStats  # noqa: F401
