import os
import sys

# Tests run on the single real CPU device (the dry-run sets its own
# device-count flag in its own process — never here).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# ---------------------------------------------------------------------------
# hypothesis shim: the container image has no `hypothesis` package and
# installing one is off-limits. The property tests only use
# @settings(max_examples=, deadline=)/@given(**st.integers(lo, hi)), so a
# deterministic mini-driver is enough: each @given test runs max_examples
# times — the all-min and all-max corner draws first, then seeded random
# draws. If real hypothesis is installed it is used untouched.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    import functools
    import inspect
    import random
    import types

    class _Integers:
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def draw(self, rng):
            return rng.randint(self.lo, self.hi)

    def _integers(min_value, max_value):
        return _Integers(min_value, max_value)

    def _given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_shim_max_examples", 20)
                rng = random.Random(0xE1A)
                names = sorted(strategies)
                corners = [{k: strategies[k].lo for k in names},
                           {k: strategies[k].hi for k in names}]
                for i in range(n):
                    if i < len(corners):
                        drawn = corners[i]
                    else:
                        drawn = {k: strategies[k].draw(rng) for k in names}
                    fn(*args, **kwargs, **drawn)
            # pytest must not see the drawn params as fixtures
            sig = inspect.signature(fn)
            wrapper.__signature__ = sig.replace(parameters=[
                p for name, p in sig.parameters.items()
                if name not in strategies])
            del wrapper.__wrapped__
            wrapper.hypothesis_shim = True
            return wrapper
        return deco

    def _settings(max_examples=20, deadline=None, **_ignored):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.HealthCheck = types.SimpleNamespace(too_slow=None)
    _hyp.assume = lambda cond: bool(cond)
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skipped where there is none")
