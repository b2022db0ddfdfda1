"""A per-test wall-clock limit for the port's threaded CPU tests (no
plugin gives per-test timeouts here): ``@bounded(seconds)`` runs the test
body on a daemon thread and fails the test if it outlasts ``seconds``.
Python cannot stop a thread, so a body that hangs keeps its thread until
the worker process exits; the test fails at once all the same, instead of
the whole run's clock."""
import functools
import threading

import pytest


def bounded(seconds):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            out = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:     # re-raised on the test thread
                    out["error"] = e

            th = threading.Thread(target=body, daemon=True)
            th.start()
            th.join(timeout=seconds)
            if th.is_alive():
                pytest.fail(f"{fn.__name__} did not finish in {seconds} s")
            if "error" in out:
                raise out["error"]
        return wrapper
    return deco
