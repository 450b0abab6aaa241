"""pytest hook for ``vrbench/tests``, whose checks of every cell run a
tiny copy of the benchmark on the CPU: ``vrbench/tests/conftest.py``
cuts the configurations its ``TINY`` names, and
``vrbench/tests/test_vrbench_spans.py`` holds each one-card cell to the
span metrics its ``SPAN_METRICS`` names. This adds what the benchmark
gained after them, to those two globals alone: ``c5-shadow`` is cut as
``c5`` (it differs in no size), and the shadow fit's span metrics join the
list, so that those checks reach the new cell too, at 16^3, and none runs
a full-size configuration on the CPU. It fails the session if either
global is missing.
"""

from pathlib import Path

TESTS = Path(__file__).resolve().parent / "tests"
DERIVED_CONFIGS = {"c5-shadow": "c5"}
SPAN_METRICS = {"adjoint_ms.shadow", "plan_ms.shadow"}


def _module(modules, name):
    """The one of ``modules`` loaded from ``vrbench/tests/<name>``."""
    for mod in modules:
        path = getattr(mod, "__file__", None)
        if path and Path(path).resolve() == TESTS / name:
            return mod
    return None


def pytest_collection_finish(session):
    items = [i for i in session.items
             if TESTS in Path(str(i.path)).resolve().parents]
    if not items:
        return
    conftest = _module(session.config.pluginmanager.get_plugins(),
                       "conftest.py")
    tiny = getattr(conftest, "TINY", None)
    if not isinstance(tiny, dict) or not set(DERIVED_CONFIGS.values()) <= set(
            tiny):
        raise RuntimeError("vrbench/tests/conftest.py has no TINY sizes of "
                           f"{sorted(set(DERIVED_CONFIGS.values()))}")
    for name, base in DERIVED_CONFIGS.items():
        tiny.setdefault(name, dict(tiny[base]))
    spans = _module({getattr(i, "module", None) for i in items},
                    "test_vrbench_spans.py")
    if spans is None:
        return
    if not isinstance(getattr(spans, "SPAN_METRICS", None), set):
        raise RuntimeError("vrbench/tests/test_vrbench_spans.py has no "
                           "SPAN_METRICS set")
    spans.SPAN_METRICS |= SPAN_METRICS
