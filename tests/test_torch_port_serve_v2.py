"""The port's serve v2 on the CPU: prefix pages, chunked prefill,
hot-swap, drain, the SLO monitor and the HTTP / stdin front ends.

Mirrors the JAX package's ``tests/test_serve_prefix.py`` (the trie and
allocator units, and the engine cases on ``llama_tiny``) and adds:

- cross-package: the port's chunked, prefix-sharing engine emits the
  JAX package's solo ``generate()`` greedy tokens on the same weights
  (a token may differ only where the JAX top-2 logit margin is inside
  the float32 tolerance of ``tests/test_torch_port_model.py``, rtol 1e-4;
  here none does);
- ``SLOMonitor.snapshot()`` equal to the JAX monitor's for the same
  seeded observation stream;
- drain on a ``PreemptionHandler`` flag, the queue bound, a real
  hot-swap to a pruned checkpoint, the HTTP routes and the stdin front
  end;
- decode attention drops a stream's workspace after a failed launch.

Bit identity (sharing on / off, chunked / whole-bucket / solo) is asked
within the port only; the load-bearing invariants are those of the
reference file: token equality, refcounts never negative, zero hits on
disjoint prompts, and a hard per-step prefill budget.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torchpruner_tpu_torch.core.segment import init_model
from torchpruner_tpu_torch.generate import generate
from torchpruner_tpu_torch.models import llama_tiny
from torchpruner_tpu_torch.serve import (
    KVCacheAllocator,
    OpenLoopTraffic,
    PrefixTrie,
    Request,
    Sampling,
    ServeEngine,
    shared_prefix_requests,
    staggered_arrivals,
    synthetic_requests,
)
from torchpruner_tpu_torch.serve.allocator import _ancestors
from torchpruner_tpu_torch.serve.engine import default_prefill_chunk

# -- trie and allocator units (test_serve_prefix.py:36-238) -------------------


def seq(n, base=0):
    return np.arange(base, base + n, dtype=np.int32)


def _pages():
    it = iter(range(100))
    return lambda protect: next(it)


def _trie_insert_match_roundtrip():
    t = PrefixTrie(page_len=4)
    plan = t.insert(seq(12), 12, _pages())
    assert [p for _, p in plan] == [0, 1, 2]
    assert t.match(seq(12), max_tokens=12)[:2] == (12, [0, 1, 2])
    assert t.match(seq(7), max_tokens=7)[:2] == (4, [0])
    assert t.match(seq(12), max_tokens=11)[:2] == (8, [0, 1])


def _trie_split_on_divergence():
    t = PrefixTrie(page_len=4)
    acquire = _pages()
    t.insert(seq(12), 12, acquire)
    other = np.concatenate([seq(8), seq(4, base=100)])
    plan = t.insert(other, 12, acquire)
    assert [i for i, _ in plan] == [2]
    n_a, pages_a, _ = t.match(seq(12), max_tokens=12)
    n_b, pages_b, _ = t.match(other, max_tokens=12)
    assert n_a == n_b == 12
    assert pages_a[:2] == pages_b[:2] and pages_a[2] != pages_b[2]


def _trie_refcount_underflow():
    t = PrefixTrie(page_len=4)
    t.insert(seq(8), 8, _pages())
    _, _, path = t.match(seq(8), max_tokens=8)
    t.pin(path)
    t.pin(path)
    assert all(n.refcount == 2 for n in path)
    t.unpin(path)
    t.unpin(path)
    assert all(n.refcount == 0 for n in path)
    with pytest.raises(RuntimeError):
        t.unpin(path)


def _trie_evict_refuses_pinned():
    t = PrefixTrie(page_len=4)
    acquire = _pages()
    t.insert(seq(4), 4, acquire)
    t.insert(seq(4, base=50), 4, acquire)
    _, pages_a, path_a = t.match(seq(4), max_tokens=4)
    t.pin(path_a)
    freed = t.evict_lru(protect=[])
    assert freed and freed != pages_a
    assert t.evict_lru(protect=[]) == []
    t.unpin(path_a)
    assert t.evict_lru(protect=[]) == pages_a


def _trie_split_inherits_refcount():
    t = PrefixTrie(page_len=4)
    acquire = _pages()
    t.insert(seq(12), 12, acquire)
    _, _, path = t.match(seq(12), max_tokens=12)
    t.pin(path)
    deep = path[-1]
    t.insert(np.concatenate([seq(4), seq(8, base=100)]), 12, acquire)
    mid = deep.parent
    assert mid is not t.root and mid.refcount == 1 and deep.refcount == 1
    assert sorted(t.evict_lru(protect=[])) == [3, 4]
    assert t.evict_lru(protect=[]) == []
    t.unpin(list(_ancestors(deep)))
    assert all(n.refcount == 0 for n in t.nodes())


def _trie_reset_returns_every_page():
    t = PrefixTrie(page_len=4)
    acquire = _pages()
    t.insert(seq(8), 8, acquire)
    t.insert(seq(8, base=50), 8, acquire)
    assert sorted(t.reset()) == [0, 1, 2, 3]
    assert t.match(seq(8), max_tokens=8)[0] == 0


def _alloc(**kw):
    return KVCacheAllocator(**{**dict(n_slots=2, max_len=32, page_len=8,
                                      prefix_pages=4), **kw})


def _alloc_miss_publish_hit_release():
    a = _alloc()
    prompt = seq(20)
    assert a.match_prefix(prompt, max_tokens=19) is None
    assert a.prefix_misses == 1
    assert [i for i, _ in a.publish_prefix(prompt, 20)] == [0, 1]
    m = a.match_prefix(prompt, max_tokens=19)
    assert m is not None and m.tokens == 16 and len(m.pages) == 2
    assert a.shared_pages == 2
    for _ in range(10):
        assert a._acquire_page(protect=[]) is not None \
            or a.prefix_pool_exhausted > 0
    a.release_prefix(m)
    a.release_prefix(m)  # idempotent
    assert a.shared_pages == 0


def _alloc_refcounts_never_negative():
    rng = np.random.default_rng(0)
    a = _alloc(prefix_pages=8)
    prompts = [seq(24, base=100 * i) for i in range(4)]
    live = []
    for _ in range(200):
        op = rng.integers(0, 3)
        p = prompts[int(rng.integers(0, len(prompts)))]
        if op == 0:
            m = a.match_prefix(p, max_tokens=23)
            if m is not None:
                live.append(m)
        elif op == 1:
            a.publish_prefix(p, int(p.size))
        elif live:
            a.release_prefix(live.pop(int(rng.integers(0, len(live)))))
        assert all(node.refcount >= 0 for node in a._trie.nodes())
    for m in live:
        a.release_prefix(m)
    assert all(n.refcount == 0 for n in a._trie.nodes())


def _alloc_evict_while_shared_refused():
    a = _alloc(prefix_pages=2)
    a.publish_prefix(seq(20), 20)
    m = a.match_prefix(seq(20), max_tokens=19)
    assert m is not None
    assert a._acquire_page(protect=[]) is None
    assert a.prefix_pool_exhausted >= 1
    a.release_prefix(m)
    assert a._acquire_page(protect=[]) is not None


def _alloc_lru_eviction_order():
    a = _alloc(prefix_pages=2)
    a.publish_prefix(seq(8), 8)
    a.publish_prefix(seq(8, base=50), 8)
    m = a.match_prefix(seq(8), max_tokens=8)
    a.release_prefix(m)
    assert a._acquire_page(protect=[]) is not None
    assert a.prefix_evictions == 1
    assert a._trie.match(seq(8), 8)[0] == 8
    assert a._trie.match(seq(8, base=50), 8)[0] == 0


def _alloc_release_unpins_split_mid():
    a = _alloc(prefix_pages=8)
    a.publish_prefix(seq(24), 24)
    m = a.match_prefix(seq(24), max_tokens=23)
    assert m is not None and m.tokens == 16
    a.publish_prefix(np.concatenate([seq(8), seq(16, base=500)]), 24)
    a.release_prefix(m)
    assert all(n.refcount == 0 for n in a._trie.nodes())
    got = set()
    while (p := a._acquire_page(protect=[])) is not None:
        got.add(p)
    assert len(got) == a.prefix_pages


def _alloc_prefix_disabled_by_default():
    a = KVCacheAllocator(n_slots=2, max_len=32, page_len=8)
    assert not a.prefix_enabled
    assert a.match_prefix(seq(16), max_tokens=15) is None
    assert a.prefix_misses == 0


UNITS = {f.__name__[1:]: f for f in (
    _trie_insert_match_roundtrip, _trie_split_on_divergence,
    _trie_refcount_underflow, _trie_evict_refuses_pinned,
    _trie_split_inherits_refcount, _trie_reset_returns_every_page,
    _alloc_miss_publish_hit_release, _alloc_refcounts_never_negative,
    _alloc_evict_while_shared_refused, _alloc_lru_eviction_order,
    _alloc_release_unpins_split_mid, _alloc_prefix_disabled_by_default)}


@pytest.mark.parametrize("case", sorted(UNITS))
def test_prefix_trie_and_allocator(case):
    UNITS[case]()


# -- the engine (test_serve_prefix.py:297-435) --------------------------------


@pytest.fixture(scope="module")
def tiny():
    model = llama_tiny()
    params, _ = init_model(model, seed=0, device="cpu")
    return model, params


def _engine(model, params, **kw):
    return ServeEngine(model, params, device="cpu",
                       **{**dict(n_slots=2, max_len=64, page_len=8), **kw})


def _serve(eng, reqs):
    eng.run(OpenLoopTraffic(reqs, staggered_arrivals(len(reqs), 2),
                            by_step=True))
    assert all(r.state == "done" for r in reqs)
    return [list(r.tokens) for r in reqs]


def _solo(model, params, req, max_len=64):
    s = req.sampling
    out = generate(model, params, req.prompt_ids[None], req.max_new,
                   max_len=max_len, temperature=s.temperature,
                   top_k=s.top_k, top_p=s.top_p,
                   rng=torch.Generator().manual_seed(int(s.seed)),
                   device="cpu")
    return out[0].tolist()


def _shared_reqs(n=4, temperature=0.0):
    return shared_prefix_requests(
        n, vocab=256, n_prefixes=2, prefix_len=16, suffix_lens=[3, 5, 9],
        max_new=[6, 8], seed=11, temperature=temperature)


def test_chunked_prefill_parity_with_legacy_and_solo(tiny):
    model, params = tiny
    reqs_c, reqs_l = _shared_reqs(), _shared_reqs()
    toks_c = _serve(_engine(model, params, prefill_chunk=8), reqs_c)
    toks_l = _serve(_engine(model, params), reqs_l)
    assert toks_c == toks_l
    for r, t in zip(reqs_c, toks_c):
        assert t == _solo(model, params, r)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_sharing_on_off_bit_identical(tiny, temperature):
    """Identical traffic with sharing ON (hits, copy-on-write,
    publication) and OFF gives bit-identical tokens, equal to solo
    decode — greedy and seeded sampling — and ON really shares."""
    model, params = tiny
    reqs_on = _shared_reqs(n=5, temperature=temperature)
    reqs_off = _shared_reqs(n=5, temperature=temperature)
    eng = _engine(model, params, prefix_pages=8, prefill_chunk=8)
    toks_on = _serve(eng, reqs_on)
    toks_off = _serve(_engine(model, params, prefill_chunk=8), reqs_off)
    alloc = eng.scheduler.allocator
    assert alloc.prefix_hits > 0 and alloc.prefix_hit_tokens >= 16
    assert toks_on == toks_off
    for r, t in zip(reqs_on, toks_on):
        assert t == _solo(model, params, r)
        assert r.prefix_hit_tokens + r.prefilled_tokens == r.prompt_ids.size
    s = eng.summary()
    assert s["prefix_hits"] == alloc.prefix_hits
    assert s["prefix_hit_tokens"] + s["prefilled_tokens"] \
        == sum(r.prompt_ids.size for r in reqs_on)


def test_disjoint_prompts_zero_hits(tiny):
    model, params = tiny
    reqs = synthetic_requests(4, vocab=256, prompt_lens=[17, 21],
                              max_new=[6], seed=5)
    eng = _engine(model, params, prefix_pages=8, prefill_chunk=8)
    toks = _serve(eng, reqs)
    alloc = eng.scheduler.allocator
    assert alloc.prefix_hits == 0 and alloc.prefix_hit_tokens == 0
    for r, t in zip(reqs, toks):
        assert t == _solo(model, params, r)


def test_prefill_cap_is_hard_per_step_budget(tiny):
    model, params = tiny
    eng = _engine(model, params, prefix_pages=8, prefill_chunk=8,
                  prefill_token_cap=8)
    _serve(eng, _shared_reqs(n=4))
    assert eng.max_prefill_tokens_step <= 8
    s = eng.summary()
    assert s["max_prefill_tokens_step"] <= s["prefill_token_cap"] == 8
    eng2 = _engine(model, params, prefill_chunk=8, prefill_token_cap=3)
    assert eng2.scheduler.prefill_budget(8) == 8


@pytest.mark.parametrize("chunk", [24, 7])
def test_chunk_must_divide_max_len(tiny, chunk):
    model, params = tiny
    with pytest.raises(ValueError):
        _engine(model, params, prefill_chunk=chunk)


@pytest.mark.parametrize("max_len, page_len, want", [
    (512, 16, 64), (64, 8, 64), (96, 16, 32), (48, 8, 16), (40, 8, 8)])
def test_default_chunk_is_chosen_from_max_len_alone(tiny, max_len,
                                                    page_len, want):
    """With sharing on and no chunk width given, the widest ladder chunk
    dividing ``max_len`` is used, whatever the page size."""
    assert default_prefill_chunk(max_len) == want
    if max_len <= 96:
        model, params = tiny
        eng = _engine(model, params, max_len=max_len, page_len=page_len,
                      prefix_pages=4)
        assert eng.prefill_chunk == want


def test_chunk_wider_than_page_realigns_after_a_hit(tiny):
    """Pages of 8 under chunks of 16 (the JAX engine refuses this
    geometry): a 24-token shared prefix hits mid-chunk, one 8-token
    chunk runs up to the grid, and tokens stay those of sharing off and
    of solo decode."""
    model, params = tiny

    def reqs():
        return shared_prefix_requests(
            5, vocab=256, n_prefixes=1, prefix_len=24, suffix_lens=[5, 11],
            max_new=[6], seed=2)

    on, off = reqs(), reqs()
    eng = _engine(model, params, prefix_pages=8, prefill_chunk=16)
    toks = _serve(eng, on)
    assert toks == _serve(_engine(model, params, prefill_chunk=16), off)
    assert eng.scheduler.allocator.prefix_hits > 0
    assert {r.prefix_hit_tokens for r in on} == {0, 24}
    for r, t in zip(on, toks):
        assert t == _solo(model, params, r)


def test_decode_interleaves_with_chunked_prefill(tiny):
    model, params = tiny
    rng = np.random.default_rng(3)
    eng = _engine(model, params, prefill_chunk=8, prefill_token_cap=8)
    short = Request(prompt_ids=rng.integers(0, 256, 4), max_new=12,
                    sampling=Sampling(seed=1))
    long = Request(prompt_ids=rng.integers(0, 256, 48), max_new=4,
                   sampling=Sampling(seed=2))
    eng.submit(short)
    for _ in range(50):
        eng.step()
        if len(short.tokens) >= 2:
            break
    eng.submit(long)
    before = len(short.tokens)
    for _ in range(6):  # the long prompt needs 6 capped chunk steps
        eng.step()
    assert len(short.tokens) > before
    for _ in range(200):
        if short.state == "done" and long.state == "done":
            break
        eng.step()
    assert short.state == "done" and long.state == "done"
    assert list(short.tokens) == _solo(model, params, short)
    assert list(long.tokens) == _solo(model, params, long)


def _pruned_checkpoint(model, params, path):
    """``block1_ffn/gate`` pruned by a quarter (64 -> 48), saved."""
    from torchpruner_tpu_torch.checkpoint import save_checkpoint
    from torchpruner_tpu_torch.core.pruner import prune

    res = prune(model, params, "block1_ffn/gate", list(range(0, 64, 4)))
    save_checkpoint(path, res.model, res.params, res.state)
    return res


def test_swap_to_pruned_checkpoint_resets_the_pool(tiny, tmp_path):
    """A hot-swap to a pruned checkpoint lands at an empty slot array:
    the prefix pool (old-weight K/V) is reset, requests before the swap
    verify against the old weights and requests after it against the
    new ones, and the new program set brings its own cache."""
    from torchpruner_tpu_torch.serve.frontend import verify_against_solo

    model, params = tiny
    res = _pruned_checkpoint(model, params, str(tmp_path / "b"))
    eng = _engine(model, params, prefix_pages=8, prefill_chunk=8)
    _serve(eng, _shared_reqs(n=3))
    alloc = eng.scheduler.allocator
    assert alloc.prefix_pool_used > 0
    old = eng.programs
    eng.request_swap(str(tmp_path / "b"))
    assert eng.health_state() == "staging_swap"
    with pytest.raises(RuntimeError):
        eng.request_swap(str(tmp_path / "b"))
    eng._swap_thread.join(timeout=60)
    assert eng.maybe_swap()
    assert eng.swaps_total == 1 and eng.health_state() == "ready"
    assert alloc.prefix_pool_used == 0 and alloc.shared_pages == 0
    assert eng.model == res.model and eng.programs is not old
    assert eng.swap_log[0]["widths"]["block1_ffn/gate"] == 48
    reqs = _shared_reqs(n=3)
    toks = _serve(eng, reqs)
    assert alloc.prefix_hits > 0
    for r, t in zip(reqs, toks):
        assert r.served_by is eng.programs
        assert t == _solo(res.model, res.params, r)
    assert verify_against_solo(eng) == 0
    assert any(r.served_by is old for r in eng.results())


def test_failed_swap_keeps_serving(tiny, tmp_path, capsys):
    model, params = tiny
    eng = _engine(model, params, prefill_chunk=8)
    eng.request_swap(str(tmp_path / "missing"))
    eng._swap_thread.join(timeout=60)
    assert not eng.maybe_swap()
    assert eng.swaps_total == 0 and eng.health_state() == "ready"
    assert "hot-swap failed" in capsys.readouterr().err
    _serve(eng, _shared_reqs(n=2))


def test_greedy_tokens_match_jax_solo_generate(tiny):
    """The port's chunked, prefix-sharing engine on the JAX weights
    emits the JAX package's solo greedy tokens."""
    import jax.numpy as jnp

    from torchpruner_tpu.core.segment import init_model as j_init_model
    from torchpruner_tpu.generate import _decode_seq as j_decode_seq
    from torchpruner_tpu.generate import generate as j_generate
    from torchpruner_tpu.generate import init_cache as j_init_cache
    from torchpruner_tpu.models import llama_tiny as j_llama_tiny
    from torchpruner_tpu_torch.convert import (
        model_from_reference,
        params_from_numpy,
    )

    jmodel = j_llama_tiny()
    jparams, _ = j_init_model(jmodel, seed=0)
    model = model_from_reference(jmodel)
    def numpy_tree(tree):
        if isinstance(tree, dict):
            return {k: numpy_tree(v) for k, v in tree.items()}
        return np.asarray(tree)

    params = params_from_numpy(numpy_tree(jparams), device="cpu")
    reqs = _shared_reqs(n=5)
    eng = _engine(model, params, prefix_pages=8, prefill_chunk=8)
    toks = _serve(eng, reqs)
    assert eng.scheduler.allocator.prefix_hits > 0
    for r, got in zip(reqs, toks):
        want = np.asarray(j_generate(jmodel, jparams,
                                     jnp.asarray(r.prompt_ids[None]),
                                     r.max_new))[0]
        diff = np.nonzero(np.asarray(got) != want)[0]
        if diff.size == 0:
            continue
        # where the two first disagree, the JAX top-2 margin must be
        # inside the float32 logit tolerance
        i = int(diff[0])
        full = np.concatenate([r.prompt_ids, want]).astype(np.int32)[None]
        jx, _ = j_decode_seq(jmodel.layers, jparams,
                             j_init_cache(jmodel, 1, full.shape[1]),
                             jnp.asarray(full), 0)
        row = np.asarray(jx)[0, r.prompt_ids.size - 1 + i]
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] <= 2e-4 * np.abs(row).max(), \
            f"request {r.id} step {i}: tokens differ at a clear margin"


# -- SLO, QoS, requests, traffic against the JAX package ----------------------


def test_slo_snapshot_matches_jax():
    from torchpruner_tpu.serve.slo import SLOMonitor as JSLO
    from torchpruner_tpu_torch.serve.slo import SLOMonitor as PSLO

    rng = np.random.default_rng(4)
    stream = [(m, float(v), 1000.0 + 0.25 * i) for i, (m, v) in enumerate(
        zip(rng.choice(["ttft", "token", "queue"], 400),
            rng.gamma(2.0, 0.02, 400)))]
    snaps = []
    for cls in (JSLO, PSLO):
        mon = cls(ttft_p99_s=0.08, token_p99_s=0.05, queue_p99_s=0.1,
                  window=64, min_samples=8, burn_fast_window_s=10.0,
                  burn_slow_window_s=40.0, burn_budget=0.05,
                  burn_threshold=2.0)
        trace = []
        for i, (m, v, ts) in enumerate(stream):
            getattr(mon, f"on_{m}")(v, ts=ts)
            if i % 16 == 15:
                trace.append((mon.check(i, now=ts), mon.snapshot(),
                              mon.in_breach_any()))
        snaps.append(trace)
    assert snaps[0] == snaps[1]
    assert snaps[1][-1][1]["breaches_total"] > 0


def test_qos_tenant_surface_matches_jax():
    from torchpruner_tpu.serve import qos as JQ
    from torchpruner_tpu_torch.serve import qos as PQ

    table = {"chat": {"priority": "interactive", "rate": 2.0, "burst": 2},
             "bulk": {"priority": "batch", "page_quota": 4}}
    out = []
    for Q in (JQ, PQ):
        b = Q.TokenBucket(2.0, 2.0, now=0.0)
        row = [b.take(now=0.0), b.take(now=0.0), b.level,
               b.retry_after_s(now=0.1), b.retry_after_s(now=1.0)]
        row.append(Q.QoS.from_dict(table, now=0.0).priorities)
        out.append(row)
    assert out[0] == out[1]


def test_request_snapshot_and_wire_schema_match_jax():
    from torchpruner_tpu.serve import request as JRQ
    from torchpruner_tpu_torch.serve import request as PRQ

    wire = {"prompt_ids": [3, 1, 4], "max_new": 5, "temperature": 0.7,
            "top_k": 3, "top_p": 0.9, "seed": 12, "session_id": "s",
            "tenant": "chat", "trace_id": "t1"}
    snaps = []
    for M in (JRQ, PRQ):
        r = M.request_from_dict(wire)
        again = M.Request.from_snapshot(json.loads(json.dumps(
            r.snapshot())))
        assert again.snapshot() == r.snapshot()
        assert (r.trace_id, r.session_id) == ("t1", "s")
        r.state = M.DONE
        assert r.finished() and r.result()["prefix_hit_tokens"] == 0
        snaps.append(r.snapshot())
    assert snaps[0] == snaps[1]


def test_shared_prefix_traffic_matches_jax():
    from torchpruner_tpu.serve import traffic as JT
    from torchpruner_tpu_torch.serve import traffic as PT

    kw = dict(vocab=256, n_prefixes=2, prefix_len=16, suffix_lens=[3, 9],
              max_new=[6, 8], seed=11, sessions=3)
    ref, got = JT.shared_prefix_requests(7, **kw), \
        PT.shared_prefix_requests(7, **kw)
    assert [r.snapshot() for r in got] == [r.snapshot() for r in ref]
    assert np.array_equal(got[0].prompt_ids[:16], got[2].prompt_ids[:16])
    traffic = PT.OpenLoopTraffic(got, PT.staggered_arrivals(7, 2),
                                 by_step=True)
    assert traffic.drain() == got and traffic.exhausted


# -- drain, queue bound -------------------------------------------------------


def test_preemption_flag_drains_and_snapshots(tiny, tmp_path):
    """A SIGTERM flag set mid-run stops admissions, finishes in-flight
    requests, and snapshots queued plus not-yet-arrived requests
    (atomically) for resubmission; later submissions bounce."""
    from torchpruner_tpu_torch.resilience.guards import PreemptionHandler
    from torchpruner_tpu_torch.serve.engine import SNAPSHOT_FILENAME

    model, params = tiny
    eng = _engine(model, params, prefix_pages=8, prefill_chunk=8,
                  run_dir=str(tmp_path))
    reqs = _shared_reqs(n=8)
    traffic = OpenLoopTraffic(reqs, staggered_arrivals(8, 3), by_step=True)
    pre = PreemptionHandler()

    class FlagAt:
        exhausted = property(lambda self: traffic.exhausted)

        def drain(self):
            return traffic.drain()

        def pump(self, engine):
            if engine.ticks == 6:
                pre.request()
            return traffic.pump(engine)

    with pre:
        summary = eng.run(FlagAt(), preemption=pre)
    done = [r for r in reqs if r.state == "done"]
    drained = [r for r in reqs if r.state == "drained"]
    assert done and drained and len(done) + len(drained) == 8
    assert summary["requests_drained"] == len(drained)
    assert summary["requests_completed"] == len(done)
    assert eng.health_state() == "draining"
    snap = json.loads((tmp_path / SNAPSHOT_FILENAME).read_text())
    assert [d["prompt_ids"] for d in snap["requests"]] \
        == [r.prompt_ids.tolist() for r in drained]
    late = eng.submit(Request(prompt_ids=[1, 2, 3], max_new=2))
    assert late.state == "drained" and late.wait(0)
    for r in done:
        assert list(r.tokens) == _solo(model, params, r)


def test_queue_bound_sheds_and_queue_wait(tiny):
    model, params = tiny
    eng = _engine(model, params, queue_bound=2)
    reqs = [Request(prompt_ids=[5, 6, 7], max_new=2, tenant="bulk")
            for _ in range(4)]
    states = [eng.submit(r).state for r in reqs]
    assert states == ["queued", "queued", "shed", "shed"]
    assert eng.scheduler.rejected == {"backpressure": 2}
    assert eng.scheduler.tenant_shed == {"bulk:backpressure": 2}
    assert reqs[2].wait(0)
    eng.run()
    assert [r.state for r in reqs[:2]] == ["done", "done"]
    waits = eng.scheduler.queue_wait_ms()
    assert set(waits) == {"p50", "p99"} and waits["p50"] >= 0
    assert eng.summary()["rejected"] == {"backpressure": 2}


# -- the front ends -----------------------------------------------------------


def _http(port, method, path, body=None, parse=json.loads):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, parse(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, parse(e.read())


def test_http_front_end(tiny, tmp_path):
    """127.0.0.1, port 0: generate, healthz, stats, swap (202, then
    staging_swap until it lands), and the obs routes as the JAX front
    end answers them: ``/metrics`` 503 without a session and 200 with
    one, ``POST /profile`` 409 without a profiler, then 202 and 409
    while the window is armed."""
    from torchpruner_tpu_torch import obs
    from torchpruner_tpu_torch.serve.frontend import _http_server

    model, params = tiny
    _pruned_checkpoint(model, params, str(tmp_path / "b"))
    eng = _engine(model, params, prefix_pages=8, prefill_chunk=8,
                  retain_results=False)
    server = _http_server(eng, 0, 60.0)
    port = server.server_address[1]
    stop = threading.Event()
    out = {}
    loop = threading.Thread(
        target=lambda: out.update(eng.run(stop_event=stop)), daemon=True)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    loop.start()
    try:
        code, health = _http(port, "GET", "/healthz")
        assert code == 200 and health["state"] == "ready"
        assert health["ok"] and health["live"] and "ts" in health
        reqs = _shared_reqs(n=3)
        for r in reqs:
            code, body = _http(port, "POST", "/v1/generate", {
                "prompt_ids": r.prompt_ids.tolist(), "max_new": r.max_new,
                "seed": r.sampling.seed})
            assert code == 200 and body["state"] == "done"
            assert body["tokens"] == _solo(model, params, r)
        code, stats = _http(port, "GET", "/stats")
        assert code == 200 and stats["admits"] == 3
        assert stats["prefix"]["hits"] > 0 and stats["state"] == "ready"
        text = bytes.decode
        assert _http(port, "GET", "/metrics", parse=text)[0] == 503
        assert _http(port, "POST", "/profile")[0] == 409
        # one-step windows: an idle engine closes one after 1 s
        session = obs.configure(str(tmp_path / "obs"), profile_steps=1)
        code, body = _http(port, "POST", "/v1/generate", {
            "prompt_ids": reqs[0].prompt_ids.tolist(),
            "max_new": reqs[0].max_new, "seed": reqs[0].sampling.seed})
        assert code == 200 and body["tokens"] == _solo(model, params,
                                                       reqs[0])
        code, prom = _http(port, "GET", "/metrics", parse=text)
        assert code == 200
        assert "serve_requests_total 1" in prom.splitlines()
        assert "serve_completed_total 1" in prom.splitlines()
        code, body = _http(port, "POST", "/profile")
        assert code == 202 and body["armed"]
        code, body = _http(port, "POST", "/profile")
        assert code == 409 and not body["armed"]
        # the idle engine loop opens the window and closes it (its own
        # thread owns the profiler session)
        for _ in range(200):
            if session.profiler.windows:
                break
            time.sleep(0.05)
        assert len(session.profiler.windows) == 1
        assert not session.profiler.windows[0].get("torn")
        assert _http(port, "POST", "/v1/generate", {"max_new": 2})[0] == 400
        assert _http(port, "GET", "/nope")[0] == 404
        code, body = _http(port, "POST", "/swap",
                           {"checkpoint": str(tmp_path / "b")})
        assert code == 202 and body["staging"]
        for _ in range(600):
            state = _http(port, "GET", "/healthz")
            if state[0] == 200 and eng.swaps_total == 1:
                break
            assert state[1]["state"] in ("staging_swap", "ready")
            time.sleep(0.05)
        assert eng.swaps_total == 1
        assert _http(port, "GET", "/stats")[1]["swaps"] == 1
    finally:
        stop.set()
        loop.join(timeout=60)
        server.shutdown()
        serve.join(timeout=10)
        obs.shutdown()
    assert out["requests_completed"] == 4 and out["swaps"] == 1


def test_stdin_front_end(monkeypatch, capsys):
    from torchpruner_tpu_torch.serve.frontend import serve_main

    lines = [json.dumps({"prompt_ids": list(range(1, 20)), "max_new": 4,
                         "seed": i}) for i in range(3)]
    lines.append("not json")
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    # one slot: each request admits after the previous one published
    assert serve_main(["llama3_ffn_taylor", "--smoke", "--cpu", "--stdin",
                       "--slots", "1",
                       "--max-len", "64", "--page-len", "8",
                       "--prefix-pages", "8", "--prefill-chunk", "8"]) == 0
    cap = capsys.readouterr()
    out = [json.loads(l) for l in cap.out.strip().splitlines()]
    assert "error" in out[0]
    results = out[1:]
    assert [r["state"] for r in results] == ["done"] * 3
    assert all(len(r["tokens"]) == 4 for r in results)
    # the obs session's summary table follows the JSON summary on stderr
    summary = json.loads(next(line for line in
                              reversed(cap.err.strip().splitlines())
                              if line.startswith("{")))
    assert summary["requests_completed"] == 3
    assert summary["prefix_hits"] == 2


def test_cli_serves_checkpoint_and_swaps(tiny, tmp_path, capsys):
    """``serve --checkpoint A --swap-checkpoint B`` on shared-prefix
    traffic: one swap to the pruned checkpoint, every request verified
    against the program set that served it."""
    from torchpruner_tpu_torch.checkpoint import save_checkpoint
    from torchpruner_tpu_torch.serve.frontend import serve_main

    model, params = tiny
    save_checkpoint(str(tmp_path / "a"), model, params)
    _pruned_checkpoint(model, params, str(tmp_path / "b"))
    rc = serve_main([
        "llama_tiny", "--cpu", "--checkpoint", str(tmp_path / "a"),
        "--swap-checkpoint", str(tmp_path / "b"), "--swap-after", "4",
        "--synthetic", "8", "--shared-prefixes", "2", "--prefix-len", "16",
        "--prompt-lens", "3,9", "--max-new", "6", "--slots", "2",
        "--max-len", "64", "--page-len", "8", "--prefix-pages", "8",
        "--prefill-chunk", "8", "--prefill-cap", "16", "--verify"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert summary["requests_completed"] == 8 and summary["swaps"] == 1
    assert summary["verify_mismatches"] == 0
    assert summary["prefix_hits"] > 0 and summary["device"] == "cpu"
    assert summary["max_prefill_tokens_step"] <= 16


# -- decode attention's workspace after a failed launch -----------------------


def test_failed_decode_launch_drops_the_stream_workspace(monkeypatch):
    """A launch that raises (the extension reports an error) drops its
    stream's merge workspace, so the next call cannot merge at a stale
    arrival count; other streams keep theirs."""
    from torchpruner_tpu_torch.ops import _build
    from torchpruner_tpu_torch.ops import decode_attention as DA

    class FakeStream:
        cuda_stream = 7

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: FakeStream())

    def boom(*args):
        raise RuntimeError("decode_attention: CUDA launch failed")

    monkeypatch.setattr(_build, "function", lambda *a, **k: boom)
    dev = torch.device("cpu")
    stale = torch.full((8,), 3, dtype=torch.int32)
    monkeypatch.setitem(DA._workspaces, (dev, 7),
                        (stale, torch.zeros(4096)))
    other = (torch.zeros(8, dtype=torch.int32), torch.zeros(16))
    monkeypatch.setitem(DA._workspaces, (dev, 8), other)
    q = torch.zeros((1, 1, 2, 8))
    kv = torch.zeros((1, 64, 2, 8))
    with pytest.raises(RuntimeError, match="launch failed"):
        DA._launch(q, kv, kv, 3)
    assert (dev, 7) not in DA._workspaces
    assert DA._workspaces[(dev, 8)] is other
    # the next call on that stream starts from zeroed counters
    cnt, _ = DA._workspace(dev, 7, 2, 64)
    assert int(cnt.abs().sum()) == 0
