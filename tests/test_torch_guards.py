"""The port's runtime dispatch guards (``repro_torch.analysis.guards``) held
to the eight contracts of the JAX package's ``tests/test_guards.py``, on
the CPU: the guard trips on implicit syncs and counts explicit ones,
counts without raising when asked, trips on a kernel-library build and
passes warm calls, the hot-path marker is inert, steady-state decode is
guard-clean with one explicit fetch a step, and an injected ``.item()``
or build trips it. On the CPU the guard patches ``torch.Tensor``'s
host-conversion entry points, as the JAX guard patches ``ArrayImpl``; a
kernel-library build (the port's counterpart of a backend compile) is
what ``kernels._build`` counts. Also: the serving hot path carries the
JAX package's marks, and an engine whose ``roofline()`` was counted
mid-run streams exactly as one whose was not. Counts are exact; streams
are equal token for token."""

import numpy as np
import pytest
import torch

from repro_torch.analysis import guards
from repro_torch.analysis.guards import DispatchGuard, HostSyncError, RecompileError
from repro_torch.configs import registry
from repro_torch.kernels import _build
from repro_torch.models import transformer as T
from repro_torch.obs import MetricsRegistry
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.swap import SwapManager


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke_cfg():
    return registry.get_smoke("qwen3-1.7b").replace(num_layers=2, vocab_size=128)


# ----------------------------------------------------------------------
# guard mechanics (no engine)
# ----------------------------------------------------------------------


def test_guard_trips_on_implicit_syncs():
    x = torch.arange(4.0)
    with DispatchGuard(max_compiles=None) as g:
        host = guards.device_get(x)  # the sanctioned explicit channel
        assert isinstance(host, np.ndarray)
        with pytest.raises(HostSyncError):
            x[0].item()
        with pytest.raises(HostSyncError):
            int(x[1])
        with pytest.raises(HostSyncError):
            bool(x[0] > 0)
    assert g.explicit_syncs == 1
    assert g.implicit_syncs == 3
    # interception is fully unwound on exit
    assert x[0].item() == 0.0 and int(x[1]) == 1
    assert "item" not in torch.Tensor.__dict__ and "__bool__" not in torch.Tensor.__dict__


@pytest.mark.parametrize("pull", ["tolist", "numpy", "__float__", "__index__", "__array__"])
def test_guard_trips_on_every_patched_entry_point(pull):
    """The rest of the patched host-conversion surface, each counted at
    the line that called it."""
    x = torch.arange(3)
    calls = {
        "tolist": lambda: x.tolist(),
        "numpy": lambda: x.numpy(),
        "__float__": lambda: float(x[0]),
        "__index__": lambda: [10, 11, 12][x[1]],
        "__array__": lambda: np.asarray(x),
    }
    with pytest.raises(HostSyncError, match=pull):
        with DispatchGuard(max_compiles=None) as g:
            calls[pull]()
    assert g.implicit_syncs == 1
    (site,) = g.sites
    assert site.startswith(f"Tensor.{pull} at ") and "test_torch_guards.py" in site
    assert np.asarray(x).tolist() == [0, 1, 2]


def test_guard_counts_without_raising_when_asked():
    x = torch.ones((2,))
    with DispatchGuard(max_compiles=None, raise_on_sync=False) as g:
        x[0].item()
        float(x[1])
    assert g.implicit_syncs == 2


def test_guard_trips_on_recompile():
    """A kernel-library build or load inside the guard (what ``_build``
    counts at each ``nvcc`` run and ``ctypes`` load) trips
    ``max_compiles=0``."""
    with pytest.raises(RecompileError):
        with DispatchGuard(max_compiles=0):
            _build._count_event()


def test_guard_passes_warm_cache_hits():
    f = torch.nn.Linear(3, 3)
    f(torch.ones((1, 3)))  # warm
    with DispatchGuard(max_compiles=0) as g:
        y = f(torch.ones((1, 3)))
        guards.device_get(y)
    assert g.compiles == 0 and g.implicit_syncs == 0


def test_hot_path_marker_is_inert():
    @guards.hot_path
    def fn(x):
        return x + 1

    assert guards.is_hot_path(fn)
    assert fn(1) == 2


def test_hot_path_marks_the_serving_path():
    """The counterparts of the JAX package's marks."""
    for fn in (Engine.step, Engine._decode_sampler, T.decode_step_paged, SwapManager.finalize):
        assert guards.is_hot_path(fn), fn


def test_guard_metrics_counters():
    reg = MetricsRegistry()
    x = torch.ones((2,))
    with DispatchGuard(max_compiles=None, raise_on_sync=False, metrics=reg):
        x[0].item()
        guards.device_get({"a": x, "b": [x]})
    assert reg["repro_guard_implicit_syncs_total"].value == 1
    assert reg["repro_guard_explicit_syncs_total"].value == 1
    assert reg["repro_guard_compiles_total"].value == 0


def test_guard_is_not_reentrant():
    with DispatchGuard(max_compiles=None):
        with pytest.raises(RuntimeError, match="reentrant"):
            DispatchGuard().__enter__()


# ----------------------------------------------------------------------
# the tier-1 guarantee: steady-state decode is guard-clean
# ----------------------------------------------------------------------


def _warmed_engine(n_reqs=3, max_new=32, sampling=None):
    cfg = _smoke_cfg()
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=4, max_len=128), device="cpu")
    rng = np.random.default_rng(11)
    for i in range(n_reqs):
        prompt = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
        eng.submit(prompt, max_new, sampling=sampling(i) if sampling else None)
    # warm-up: admission (prefill and its fetch) and the first decode
    fins = eng.step()
    assert not fins and len(eng.scheduler.active()) == n_reqs
    return eng


@pytest.mark.parametrize("sampled", [False, True])
def test_steady_state_decode_is_guard_clean(sampled):
    sampling = (lambda i: SamplingParams(temperature=0.8, top_k=20, seed=i)) if sampled else None
    eng = _warmed_engine(sampling=sampling)
    n_steps = 6
    with DispatchGuard(max_compiles=0) as g:
        for _ in range(n_steps):
            fins = eng.step()
            assert not fins  # steady state: nobody finishes mid-guard
    assert g.compiles == 0, "a kernel library was built after warm-up"
    assert g.implicit_syncs == 0
    # exactly one batched fetch (the next-token row) per decode step
    assert g.explicit_syncs == n_steps
    # the engine is still healthy afterwards: drain to completion
    fins = eng.drain(max_steps=200)
    assert len(fins) == 3


def test_injected_item_trips_the_guard(monkeypatch):
    eng = _warmed_engine()
    orig = T.decode_step_paged

    def leaky_decode(*args, **kw):
        logits, caches = orig(*args, **kw)
        logits[0, 0].item()  # the classic per-step scalar pull
        return logits, caches

    monkeypatch.setattr(T, "decode_step_paged", leaky_decode)
    with pytest.raises(HostSyncError, match="item"):
        with DispatchGuard(max_compiles=0):
            eng.step()


def test_injected_recompile_trips_the_guard(monkeypatch):
    eng = _warmed_engine()
    orig = T.decode_step_paged

    def rebuilding_decode(*args, **kw):
        _build._count_event()  # a kernel library built or loaded mid-traffic
        return orig(*args, **kw)

    monkeypatch.setattr(T, "decode_step_paged", rebuilding_decode)
    with pytest.raises(RecompileError):
        with DispatchGuard(max_compiles=0):
            eng.step()


def test_roofline_mid_run_leaves_streams_unchanged():
    """``roofline()`` runs one counted decode step against the trash page;
    called between two steps it changes no stream, greedy or sampled."""
    sampling = lambda i: SamplingParams(temperature=0.8, top_k=20, seed=i) if i % 2 else None  # noqa: E731

    def serve(probe: bool):
        eng = _warmed_engine(n_reqs=4, max_new=20, sampling=sampling)
        for _ in range(5):
            eng.step()
        if probe:
            assert eng.roofline()["available"]
        return {f.uid: f.tokens.tolist() for f in eng.drain(max_steps=200)}

    assert serve(True) == serve(False)
