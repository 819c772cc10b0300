"""``adamw.update`` on bfloat16 leaves against the reference's, and its
float32 path against the update as it was before the bfloat16 decay was
rounded in p's dtype.

The reference computes ``p - lr·(m̂/(√v̂ + ε) + wd·p)`` with ``wd·p`` in
p's dtype (a weakly typed Python float takes bfloat16) and the rest in
float32, the clipped bfloat16 gradient included (``g * scale`` promotes);
the port does too. Over 5 steps the port is bit-equal to the reference's
update run op by op, and every element stays within one bfloat16 ulp of
the jitted update (XLA fuses the float32 intermediates of
``m̂/(√v̂ + ε)`` and rounds them otherwise, which moves a few elements
across a rounding boundary). float32 leaves must be bit-equal to the
earlier float32 arithmetic, restated here as ``_float32_update``.
The machine with the card has no jax, so this module imports it only
inside the tests that use it.
"""
import numpy as np
import pytest
import torch

from repro_torch.optim import adamw

SHAPES = {"w": (64, 48), "b": (1024,)}          # 4,096 elements
STEPS = 5
CFG = adamw.AdamWConfig(lr=3e-2, warmup_steps=2, total_steps=10,
                        weight_decay=0.1, clip_norm=1.0)


def _draw(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _ordered(a: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (as int16) mapped to integers whose order is
    the values' order: one ulp apart is one apart."""
    bits = a.astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("jit", [False, True])
def test_bf16_update_within_one_ulp_of_reference(jit):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import adamw as radamw
    rng = np.random.default_rng(0)
    p0 = _draw(rng)
    rp = {k: jnp.asarray(v, dtype=jnp.bfloat16) for k, v in p0.items()}
    rs = radamw.init(rp)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p0.items()}
    ts = adamw.init(tp)
    update = lambda g, s, p: radamw.update(g, s, p, CFG)   # noqa: E731
    if jit:
        update = jax.jit(update)
    ulps = 1 if jit else 0
    off = []
    for i in range(STEPS):
        g = _draw(rng, 0.05 if i % 2 else 2.0)
        rg = {k: jnp.asarray(v, dtype=jnp.bfloat16) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).bfloat16() for k, v in g.items()}
        rp, rs, _ = update(rg, rs, rp)
        adamw.update(tg, ts, tp, CFG)
        n = 0
        for k in SHAPES:
            assert tp[k].dtype == torch.bfloat16
            want = np.asarray(jax.lax.bitcast_convert_type(rp[k], jnp.int16))
            got = _bf16_bits(tp[k])
            d = np.abs(_ordered(got) - _ordered(want))
            assert d.max() <= ulps, (i, k, int(d.max()))
            n += int((d > 0).sum())
        off.append(n)
    print(f"jit={jit}: elements one bf16 ulp off the reference, step by "
          f"step: {off} of {sum(np.prod(s) for s in SHAPES.values())}")


def _float32_update(grads, state, params, cfg):
    """The float32 path of ``adamw.update`` before the bfloat16 repair
    (the clip in place, ``weight_decay * p`` in float32), op for op."""
    gnorm = adamw.global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    for g in grads.values():
        g.mul_(scale)
    state["step"] += 1
    lr = adamw.schedule(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    sf = state["step"].float()
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)
    with torch.no_grad():
        for k in sorted(params):
            p, g, m, v = params[k], grads[k], state["m"][k], state["v"][k]
            gf = g.float()
            t = torch.mul(gf, 1 - b1)
            m.mul_(b1).add_(t)
            torch.mul(gf, 1 - b2, out=t).mul_(gf)
            v.mul_(b2).add_(t)
            torch.div(v, bc2, out=t).sqrt_().add_(cfg.eps)
            u = torch.div(m, bc1).div_(t)
            u.add_(torch.mul(p.float(), cfg.weight_decay, out=t))
            u.mul_(lr)
            p.sub_(u)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def test_float32_update_unchanged_bit_for_bit():
    rng = np.random.default_rng(1)
    p0 = _draw(rng)
    pa = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    pb = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sa, sb = adamw.init(pa), adamw.init(pb)
    for i in range(STEPS):
        g = _draw(rng, 0.05 if i % 2 else 2.0)
        _, _, ma = adamw.update({k: torch.from_numpy(v.copy())
                                 for k, v in g.items()}, sa, pa, CFG)
        _, _, mb = _float32_update({k: torch.from_numpy(v.copy())
                                    for k, v in g.items()}, sb, pb, CFG)
        assert torch.equal(ma["grad_norm"], mb["grad_norm"])
        for k in SHAPES:
            assert torch.equal(pa[k], pb[k]), (i, k)
            assert torch.equal(sa["m"][k], sb["m"][k])
            assert torch.equal(sa["v"][k], sb["v"][k])
