"""The slab loop (``ops.slab_loop``: the loop form of ``slab.cu``'s slab
kernel, every lane's steps and stopping rule in one launch) and the path
each estimate takes.

On the CPU: the wrapper's checks, and the choice of path (CPU tensors and
pooled stopping run the prober's host loop of ``slab_qualify`` steps).

The ``cuda``-marked tests skip without a card. On the card: the loop's
final state is bit-equal to the host loop's on the same inputs (exact,
float ADC, banded, uint8 and packed 4-bit routes; chunks of 128 and 512,
a cluster of 4 blocks a lane), with lanes that end by the visit budget, by
condition (2) and after walking every ring; an estimate whose inputs are
on the card makes no host sync before its answer; the loop's tally equals
the host loop's kept counts, with nothing discarded."""
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import estimator as E, prober
from repro_torch.core.config import ProberConfig
from repro_torch.data import vectors
from repro_torch.kernels import ops
from repro_torch.launch.mesh import fake_world

N, DIM, NQ = 20000, 32, 16
# radii at 0.2, 1, 3 and 6 times a query's second paper radius; with these
# budgets some lanes stop by condition (2), some at the visit budget and
# some after walking all six rings
CFG = ProberConfig(n_tables=2, n_funcs=6, ring_budget=256,
                   central_budget=1024, max_visit=2048, chunk=128, eps=0.06,
                   pq_m=8, pq_kc=16, pq_iters=4)
SCALES = (0.2, 1.0, 3.0, 6.0)


def _to(obj, dev):
    """A state (nested NamedTuples of tensors) on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, dev) for v in obj))
    return obj


def _inputs(cfg: ProberConfig, dev):
    """The index, queries, radii and round keys, made on the CPU from
    fixed seeds and moved to ``dev``."""
    g = torch.Generator().manual_seed(0)
    x = vectors.make_corpus(g, N, DIM)
    qs, taus, _ = vectors.paper_query_workload(g, x, NQ, n_taus=4)
    taus = taus[:, 1:2] * torch.tensor([SCALES])
    state = E.build(x, cfg, generator=torch.Generator().manual_seed(1),
                    device="cpu")
    q = qs.repeat_interleave(len(SCALES), 0)
    rks = E.draw_round_keys(torch.Generator().manual_seed(2), q.shape[0],
                            cfg.n_tables, "cpu")
    return (_to(state, dev), q.to(dev), taus.reshape(-1).to(dev),
            rks.to(dev))


def _lanes(cfg, state, q, t, rks):
    return prober.setup_lanes(state.index, state.x, q, t, cfg, rks,
                              **E._pq_args(state, q, cfg))


def _loop_args(b: prober.Lanes, cfg: ProberConfig):
    c = b.ctx
    return (b.state, b.lane, b.lane_t, c.rks, c.prings, c.caps, c.nbits,
            c.totals_f, c.w_caps, c.first_targets, c.cums,
            b.view.bucket_starts, b.view.order, b.qual, cfg.chunk,
            cfg.a_const, cfg.eps, c.visit_budget, cfg.schedule_checks)


# ---- on the CPU: the wrapper's checks and the choice of path --------------

@pytest.fixture(scope="module")
def cpu_inputs():
    return _inputs(CFG, "cpu")


def test_slab_loop_wrapper_checks_its_inputs(cpu_inputs):
    b = _lanes(CFG, *cpu_inputs)
    args = list(_loop_args(b, CFG))
    ops.reset_launches()
    ops.reset_work()
    with pytest.raises(ValueError, match="card only"):
        ops.slab_loop(*args)
    bad = dict(b.state, k=b.state["k"].long())
    with pytest.raises(TypeError, match="k:"):
        ops.slab_loop(bad, *args[1:])
    bad = dict(b.state, est=b.state["est"][:-1])
    with pytest.raises(ValueError, match="shapes"):
        ops.slab_loop(bad, *args[1:])
    for i in (4, 8):              # a ring table cut by a ring
        cut = list(args)
        cut[i] = args[i][:, :-1].contiguous()
        with pytest.raises(ValueError, match="shapes"):
            ops.slab_loop(*cut)
    cut = list(args)
    cut[13] = args[13]._replace(qs=args[13].qs[:-1])
    with pytest.raises(ValueError, match="shapes"):
        ops.slab_loop(*cut)
    for i, v in ((14, 0), (17, 0)):   # chunk, visit budget
        cut = list(args)
        cut[i] = v
        with pytest.raises(ValueError, match="chunk >= 1"):
            ops.slab_loop(*cut)
    with pytest.raises(ValueError, match="no kernel"):
        ops.slab_loop({k: v.to("meta") for k, v in b.state.items()},
                      *(a.to("meta") if isinstance(a, torch.Tensor) else a
                        for a in args[1:13]),
                      ops.Qual(*(t.to("meta") for t in b.qual[:3])),
                      *args[14:])
    assert ops.LAUNCHES["slab_loop"] == ops.WORK["slab_loop"]["calls"] == 0


@pytest.mark.parametrize("dev,group,want", [
    ("cuda", None, True), ("cuda", "pooled", False), ("cpu", None, False),
    ("cpu", "pooled", False)])
def test_slab_loop_runs_on_the_card_under_local_stopping_only(dev, group,
                                                               want):
    assert prober._device_loop(torch.device(dev), group) is want


def test_cpu_and_pooled_estimates_take_the_host_loop(cpu_inputs):
    state, q, t, rks = cpu_inputs
    ops.reset_work()
    want = E.estimate_batch_stats(state, q, t, CFG, rks=rks)
    steps = ops.WORK["slab_qualify"]["calls"]
    assert steps > 0 and ops.WORK["slab_loop"]["calls"] == 0
    record = []
    with fake_world(1):
        got = E.estimate_batch_pooled(state, q, t, CFG, rks,
                                      dist.group.WORLD, with_stats=True,
                                      steps=record)
    assert ops.WORK["slab_qualify"]["calls"] == 2 * steps
    assert ops.WORK["slab_loop"]["calls"] == 0
    for a, b in zip(want, got):    # one rank pools its own statistics
        assert torch.equal(a, b)
    # the host loop records each step's done mask, one a step
    assert len(record) == 1 and len(record[0]) == steps
    counted = prober.slab_steps(record)
    assert 0 < counted["longest_lane"] <= steps <= counted["lane_steps"]


@pytest.mark.parametrize("record,want", [
    ([torch.tensor([3, 0, 5], dtype=torch.int32)], (8, 5)),
    ([[torch.tensor([False, False, False]), torch.tensor([True, False,
                                                          False]),
       torch.tensor([True, True, False]), torch.tensor([True, True,
                                                        True])]], (6, 3)),
    ([torch.tensor([2, 4], dtype=torch.int32),
      [torch.tensor([False]), torch.tensor([True])]], (7, 4)),
    ([torch.zeros(0, dtype=torch.int32), []], (0, 0)),
])
def test_slab_steps_reads_either_loop_alike(record, want):
    """Per-lane steps (the slab loop's) and per-step done masks (the host
    loop's, a discarded step included) reduce to one schema."""
    got = prober.slab_steps(record)
    assert (got["lane_steps"], got["longest_lane"]) == want


def test_host_loop_steps_are_the_tally_kept_lane_steps(cpu_inputs):
    from torch.profiler import ProfilerActivity, profile
    state, q, t, rks = cpu_inputs
    cfg = CFG.replace(lane_block=4)     # blocks with discarded steps
    record = []
    prober.reset_tally()
    with profile(activities=[ProfilerActivity.CPU]):
        E.estimate_batch(state, q, t, cfg, rks=rks, steps=record)
    tally = prober.read_tally()
    prober.reset_tally()
    counted = prober.slab_steps(record)
    assert tally["discarded_lane_steps"] > 0
    assert counted["lane_steps"] == tally["kept_lane_steps"] > 0
    assert len(record[0]) >= counted["longest_lane"] > 0


# ---- on the card: the loop against the host loop -------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the slab loop is a CUDA kernel")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


CASES = {
    "exact-128": dict(),
    "exact-512": dict(chunk=512),
    "float-128": dict(use_pq=True),
    "banded-128": dict(use_pq=True, pq_banded=True),
    "q8-128": dict(use_pq=True, pq_int8_lut=True),
    "float-packed-512": dict(use_pq=True, pq_pack4=True, chunk=512,
                             pq_exact_rings=0),
    "q8-packed-512": dict(use_pq=True, pq_int8_lut=True, pq_pack4=True,
                          chunk=512),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_slab_loop_state_equals_host_loop(name):
    _card()
    cfg = CFG.replace(**CASES[name])
    inputs = _inputs(cfg, "cuda")
    host = _lanes(cfg, *inputs)
    loop = _lanes(cfg, *inputs)
    init_done = host.state["done"].clone()
    ops.reset_launches()
    prober._run_lanes(host.state, host.ctx, host.view, host.lane_t,
                      host.qual, cfg)
    steps = ops.LAUNCHES["slab_qualify"]
    counts = prober._loop_lanes(loop.state, loop.ctx, loop.view, loop.lane,
                                loop.lane_t, loop.qual, cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["slab_loop"] == 1
    assert ops.LAUNCHES["slab_qualify"] == steps > 0
    for nm, _ in ops.LOOP_STATE:
        assert torch.equal(_bits(loop.state[nm]), _bits(host.state[nm])), nm
    h = host.state
    ptf = h["ptf"]
    budget = (h["nvisited"] >= host.ctx.visit_budget) & ~init_done
    walked = (h["k"] > cfg.n_funcs) & ~ptf & ~budget
    assert h["done"].all()
    assert int(ptf.sum()) and int(budget.sum()) and int(walked.sum()), \
        (int(ptf.sum()), int(budget.sum()), int(walked.sum()))
    # lanes done at entry take no step; the others at least one
    assert torch.equal(counts[:, 2] == 0, init_done)
    if cfg.use_pq and cfg.pq_exact_rings < cfg.n_funcs:
        assert int(counts[:, 1].sum()) > 0       # the ADC route ran


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["exact-128", "q8-packed-512"])
def test_cuda_estimate_makes_no_host_sync(name):
    _card()
    cfg = CFG.replace(**CASES[name])
    state, q, t, rks = _inputs(cfg, "cuda")
    want = E.estimate_batch_stats(state, q, t, cfg, rks=rks)   # warm
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = E.estimate_batch_stats(state, q, t, cfg, rks=rks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.LAUNCHES["slab_loop"] == 1
    assert ops.LAUNCHES["slab_qualify"] == 0
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_pooled_stopping_takes_the_host_loop():
    _card()
    state, q, t, rks = _inputs(CFG, "cuda")
    want = E.estimate_batch_stats(state, q, t, CFG, rks=rks)
    ops.reset_launches()
    with fake_world(1):
        got = E.estimate_batch_pooled(state, q, t, CFG, rks,
                                      dist.group.WORLD, with_stats=True)
    assert ops.LAUNCHES["slab_loop"] == 0 and ops.LAUNCHES["slab_qualify"]
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["exact-128", "float-128"])
def test_cuda_loop_tally_equals_host_loop_kept_counts(name):
    _card()
    from torch.profiler import ProfilerActivity, profile
    cfg = CFG.replace(**CASES[name])
    state, q, t, rks = inputs = _inputs(cfg, "cuda")
    record = []
    prober.reset_tally()
    with profile(activities=[ProfilerActivity.CPU]):
        E.estimate_batch(state, q, t, cfg, rks=rks, steps=record)
    loop = prober.read_tally()
    host = _lanes(cfg, *inputs)
    kept = []
    prober._run_lanes(host.state, host.ctx, host.view, host.lane_t,
                      host.qual, cfg, kept=kept)
    prober.reset_tally()
    prober._tally(kept, host.qual, cfg.n_funcs)
    want = prober.read_tally()
    prober.reset_tally()
    assert loop["calls"] == want["calls"] == 1
    assert loop["discarded"] == loop["discarded_lane_steps"] == 0
    for f in ("exact", "adc", "kept_lane_steps"):
        assert loop[f] == want[f], f
    # the loop's per-lane steps and the host loop's done masks agree
    assert isinstance(record[0], torch.Tensor)
    steps = prober.slab_steps(record)
    assert steps == prober.slab_steps([[done for *_, done in kept]])
    assert steps["lane_steps"] == loop["kept_lane_steps"] > 0
    assert loop["exact"] > 0 and (loop["adc"] > 0) == cfg.use_pq
