"""The port's serving path (``repro_torch.serving``) against the JAX
package's on the CPU: the page allocator, greedy tokens of whole engine
runs, eviction under page pressure, and one host transfer per iteration."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from benchmarks.bench_serve import poisson_trace  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.serving import OutOfPages as JOutOfPages  # noqa: E402
from repro.serving import PagePool as JPagePool  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (OutOfPages, PagePool,  # noqa: E402
                                 ServeEngine)


@pytest.fixture(scope="module")
def gemma():
    cfg = get_config("gemma-2b", reduced=True)
    params, _ = registry.init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, port_config("gemma-2b", reduced=True), tp


def _script(pool, oom):
    """A fixed alloc/free script; the allocation sequence it observes."""
    seen = []
    a = pool.alloc(3)
    b = pool.alloc(2)
    seen += [a, b]
    pool.free([a[1], b[0]])
    seen.append(pool.alloc(1))
    seen.append(pool.alloc(2))
    pool.free(a[:1] + seen[-1])
    seen.append(pool.alloc(3))
    try:
        pool.alloc(4)
    except oom:
        seen.append("oom")
    seen.append((pool.free_pages, pool.used_pages))
    return seen


def test_page_pool_allocation_sequence_matches_reference(gemma):
    cfg, _, tcfg, _ = gemma
    want = _script(JPagePool(cfg, pool_pages=8, page=4), JOutOfPages)
    got = _script(PagePool(tcfg, pool_pages=8, page=4, device="cpu"),
                  OutOfPages)
    assert got == want
    assert "oom" in got


def test_write_prefill_updates_pools_in_place(gemma):
    *_, tcfg, tp = gemma
    from repro_torch.models import transformer
    pool = PagePool(tcfg, pool_pages=4, page=4, device="cpu")
    k_before = pool.pools["k"]
    _, cache = transformer.prefill(tp, tcfg, torch.tensor([[1, 2, 3, 4, 5]]))
    pool.write_prefill(cache, [2, 0], 5)
    assert pool.pools["k"] is k_before
    torch.testing.assert_close(pool.pools["k"][:, 8:12], cache.k[:, 0, :4],
                               rtol=0, atol=0)
    torch.testing.assert_close(pool.pools["v"][:, 0:1], cache.v[:, 0, 4:5],
                               rtol=0, atol=0)


def _run(engine, reqs):
    rids = [engine.submit(p, n) for p, n in reqs]
    results = engine.run()
    return [results[r]["tokens"] for r in rids], results


def test_engine_greedy_tokens_match_reference_on_bench_trace(gemma):
    """bench_serve.py's seed-0 trace (10 requests, 4 slots, page 8):
    every request's greedy tokens equal the JAX engine's."""
    cfg, params, tcfg, tp = gemma
    reqs = [(r["prompt"], r["max_new"]) for r in poisson_trace(cfg.vocab_size)]
    want, _ = _run(JServeEngine(cfg, params, max_slots=4, max_len=64, page=8,
                                interpret=True), reqs)
    engine = ServeEngine(tcfg, tp, max_slots=4, max_len=64, page=8,
                         device="cpu")
    got, _ = _run(engine, reqs)
    assert got == want
    assert engine.kernel_calls < sum(len(t) for t in got)


def test_engine_eviction_under_pressure_matches_reference(gemma):
    """tests/test_serving.py's pressure setup (4 slots, 7 pages of 4): the
    port evicts too, and still emits the JAX engine's tokens."""
    cfg, params, tcfg, tp = gemma
    key = jax.random.PRNGKey(11)
    prompts = [jax.random.randint(k, (n,), 0, cfg.vocab_size).tolist()
               for k, n in zip(jax.random.split(key, 4), (5, 6, 4, 7))]
    reqs = [(p, 5) for p in prompts]
    want, _ = _run(JServeEngine(cfg, params, max_slots=4, max_len=16, page=4,
                                pool_pages=7, interpret=True), reqs)
    engine = ServeEngine(tcfg, tp, max_slots=4, max_len=16, page=4,
                         pool_pages=7, device="cpu")
    got, results = _run(engine, reqs)
    assert sum(r["request"].evictions for r in results.values()) > 0
    assert got == want


def test_one_host_transfer_per_iteration(gemma):
    """Each iteration reads the device once for its decode step, plus once
    per prompt it admits (that prompt's first token)."""
    *_, tcfg, tp = gemma
    engine = ServeEngine(tcfg, tp, max_slots=2, max_len=32, page=4,
                         device="cpu")
    rng = np.random.default_rng(5)
    for n in (5, 9, 3):
        engine.submit(rng.integers(0, tcfg.vocab_size, n).tolist(), 6)
    while not engine.idle:
        admitted0, before = len(engine._waiting), engine.host_transfers
        calls0 = engine.kernel_calls
        engine.step()
        admitted = admitted0 - len(engine._waiting)
        decoded = engine.kernel_calls - calls0
        assert decoded in (0, 1)
        assert engine.host_transfers - before == admitted + decoded


def test_engine_scope_and_device_policy(gemma, monkeypatch):
    *_, tcfg, tp = gemma
    # batched=False on the paged path decodes one slot at a time
    engine = ServeEngine(tcfg, tp, batched=False, device="cpu")
    assert engine.paged and not engine.batched
    with pytest.raises(NotImplementedError, match="re-layout.*greedy_generate"):
        ServeEngine(tcfg.with_(family="hybrid"), tp, device="cpu")
    with pytest.raises(NotImplementedError, match="contiguous"):
        ServeEngine(tcfg.with_(family="vlm"), tp, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="forward->decode.*greedy_generate"):
        ServeEngine(tcfg.with_(family="moe"), tp, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tcfg, tp)


@pytest.fixture(scope="module")
def mamba():
    cfg = get_config("mamba2-780m", reduced=True)
    params, _ = registry.init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, port_config("mamba2-780m", reduced=True), tp


def test_ssm_engine_greedy_tokens_match_reference(mamba):
    """Reduced mamba2-780m through the per-slot contiguous path: 4
    requests on 2 slots, one prompt longer than the chunk (8), so its
    prefill carries the state across a chunk boundary and pads its last
    chunk, the others a ragged chunk; every request's greedy tokens equal
    the JAX engine's, and each iteration reads the device once for its
    decode plus once per prompt it admits."""
    cfg, params, tcfg, tp = mamba
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), m)
            for n, m in ((5, 6), (13, 4), (3, 7), (9, 5))]
    want, _ = _run(JServeEngine(cfg, params, max_slots=2, max_len=32,
                                interpret=True), reqs)
    engine = ServeEngine(tcfg, tp, max_slots=2, max_len=32, device="cpu")
    assert engine.pool is None
    rids = [engine.submit(p, n) for p, n in reqs]
    while not engine.idle:
        waiting, before = len(engine._waiting), engine.host_transfers
        calls0 = engine.kernel_calls
        engine.step()
        admitted = waiting - len(engine._waiting)
        decoded = engine.kernel_calls - calls0
        assert engine.host_transfers - before == admitted + (decoded > 0)
    results = engine.results()
    assert [results[r]["tokens"] for r in rids] == want
    assert engine.kernel_calls == sum(n for _, n in reqs) - len(reqs)


def test_ssm_engine_rejects_prompts_shorter_than_the_conv_tail(mamba):
    """A prompt shorter than conv_width - 1 tokens leaves the reference's
    prefill a conv tail its decode step cannot extend: the port refuses it
    at submission, naming the cause."""
    *_, tcfg, tp = mamba
    engine = ServeEngine(tcfg, tp, device="cpu")
    with pytest.raises(ValueError, match="conv_width - 1 = 3"):
        engine.submit([1, 2], 4)
    with pytest.raises(ValueError, match="batched decode needs the paged"):
        ServeEngine(tcfg, tp, batched=True, device="cpu")
    engine.submit([1, 2, 3], 1)
    assert len(engine.run()) == 1
