"""pvd_tpu_torch compositing against the JAX package (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.ops.composite import composite_rays as j_composite_rays
from pvd_tpu.ops.composite import composite_rays_compact as j_compact_comp
from pvd_tpu.render.renderer import compact_samples as j_compact
from pvd_tpu_torch.ops.composite import (composite_rays,
                                         composite_rays_compact)

torch.set_num_threads(1)

# transmittance is a product in another association order than the JAX
# package's associative_scan, and the per-ray sums run in another order
COMP_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _stream(seed, n_rays=30, s=20, budget=256):
    """A compacted eval stream (prefix=False): valid prefix in ray order,
    then an invalid tail whose ray_id is 0."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(n_rays, s)) < 0.35
    mask[::6] = False
    c = j_compact(jnp.asarray(mask), budget, prefix=False)
    M = budget
    # densities spanning empty space to opaque: alpha = 1 happens
    sig = rng.choice([0.0, 0.5, 5.0, 80.0, 1e4], size=M).astype(np.float32)
    sig *= rng.uniform(0.5, 1.5, M).astype(np.float32)
    rgb = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    valid = np.asarray(c.valid)
    dt = np.where(valid, np.float32(2 * np.sqrt(3) / 128), 0).astype(
        np.float32)
    t_cum = np.where(valid, rng.uniform(0.2, 3.0, M), 0).astype(np.float32)
    return sig, rgb, dt, t_cum, np.asarray(c.ray_id), valid, n_rays


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_composite_compact_matches_jax(early_stop, seed):
    sig, rgb, dt, t_cum, rid, valid, n = _stream(seed)
    assert not valid[-1] and rid[-1] == 0  # the zero ray_id tail
    want = j_compact_comp(jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(dt),
                          jnp.asarray(t_cum), jnp.asarray(rid),
                          jnp.asarray(valid), n, early_stop=early_stop)
    got = composite_rays_compact(_t(sig), _t(rgb), _t(dt), _t(t_cum),
                                 _t(rid).long(), _t(valid), n,
                                 early_stop=early_stop)
    for g, w, name in zip(got, want, ("weights_sum", "depth", "image",
                                      "weights")):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=COMP_TOL,
                                   atol=COMP_TOL, err_msg=name)
    ws = got[0].numpy()
    assert ws.max() > 0.99 and (ws == 0).any()


@pytest.mark.parametrize("early_stop", [False, True])
def test_composite_padded_matches_jax(early_stop):
    rng = np.random.default_rng(4)
    N, S = 16, 24
    mask = rng.uniform(size=(N, S)) < 0.6
    sig = rng.choice([0.0, 3.0, 50.0, 1e4], size=(N, S)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    dt = np.full((N, S), 0.027, np.float32)
    dd = rng.uniform(0.01, 0.1, (N, S)).astype(np.float32)
    want = j_composite_rays(*(jnp.asarray(a) for a in (sig, rgb, dt, dd,
                                                       mask)),
                            early_stop=early_stop)
    got = composite_rays(*(_t(a) for a in (sig, rgb, dt, dd, mask)),
                         early_stop=early_stop)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=COMP_TOL,
                                   atol=COMP_TOL)


# gradients: the same closed form reached by two autodiffs (a padded
# cumprod here, an associative scan there), summed in other orders
GRAD_TOL = 1e-5


def _grad_stream(seed):
    """A compacted train stream: rays of 0, 1 and many valid samples in ray
    order, then an invalid tail that carries ray 0."""
    rng = np.random.default_rng(seed)
    counts = np.array([0, 1, 7, 0, 1, 12, 3, 0, 20, 5], np.int64)
    n, total, M = counts.size, int(counts.sum()), int(counts.sum()) + 11
    rid = np.zeros(M, np.int64)
    rid[:total] = np.repeat(np.arange(n), counts)
    valid = np.arange(M) < total
    sig = rng.choice([0.0, 0.5, 5.0, 80.0], size=M).astype(np.float32)
    sig *= rng.uniform(0.5, 1.5, M).astype(np.float32)
    rgb = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    dt = np.where(valid, np.float32(2 * np.sqrt(3) / 128), 0).astype(
        np.float32)
    t_cum = np.where(valid, rng.uniform(0.2, 3.0, M), 0).astype(np.float32)
    g = [rng.normal(size=s).astype(np.float32) for s in ((n,), (n,), (n, 3))]
    return sig, rgb, dt, t_cum, rid, valid, n, g


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_compact_grad_matches_jax(seed):
    """d(sigma), d(rgb) of a loss over weights_sum, depth and image."""
    import jax

    sig, rgb, dt, t_cum, rid, valid, n, (a, b, c) = _grad_stream(seed)

    def j_loss(s, r):
        ws, depth, image, _ = j_compact_comp(
            s, r, jnp.asarray(dt), jnp.asarray(t_cum), jnp.asarray(rid),
            jnp.asarray(valid), n)
        return jnp.sum(ws * a) + jnp.sum(depth * b) + jnp.sum(image * c)

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(sig),
                                            jnp.asarray(rgb))
    s_t = _t(sig).requires_grad_()
    r_t = _t(rgb).requires_grad_()
    ws, depth, image, _ = composite_rays_compact(
        s_t, r_t, _t(dt), _t(t_cum), _t(rid), _t(valid), n)
    ((ws * _t(a)).sum() + (depth * _t(b)).sum()
     + (image * _t(c)).sum()).backward()
    for got, w, name in ((s_t.grad, want[0], "sigma"),
                         (r_t.grad, want[1], "rgb")):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(got.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
    # invalid slots get nothing
    assert not s_t.grad.numpy()[~valid].any()
    assert not r_t.grad.numpy()[~valid].any()


def _padded_block(seed, N=16, S=24):
    """A padded [N, S] block: arbitrary masks (eval) and prefix masks
    (train), densities from empty to opaque, and upstream gradients of all
    four outputs."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(N, S)) < 0.6
    lens = rng.integers(0, S + 1, N // 2)
    mask[N // 2:] = np.arange(S)[None] < lens[:, None]
    sig = rng.choice([0.0, 0.5, 3.0, 50.0, 1e4], size=(N, S)).astype(
        np.float32)
    sig *= rng.uniform(0.5, 1.5, (N, S)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    dt = np.where(mask, 0.027, rng.choice([0.0, 0.027], (N, S))).astype(
        np.float32)
    dd = rng.uniform(0.01, 0.1, (N, S)).astype(np.float32)
    g = [rng.normal(size=s).astype(np.float32)
         for s in ((N,), (N,), (N, 3), (N, S))]
    return (sig, rgb, dt, dd, mask), g


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_padded_grad_matches_jax(seed):
    """d(sigma), d(rgb) of the padded composite against JAX's autodiff
    (the cumprod), through autograd on the plain version and through
    composite_rays_bwd_plain (K9's plain version)."""
    import jax

    from pvd_tpu_torch.ops.composite import composite_rays_bwd_plain

    (sig, rgb, dt, dd, mask), g = _padded_block(seed)

    def j_loss(s, r):
        outs = j_composite_rays(s, r, jnp.asarray(dt), jnp.asarray(dd),
                                jnp.asarray(mask))
        return sum(jnp.sum(o * gi) for o, gi in zip(outs, g))

    want = [np.asarray(w) for w in jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(sig), jnp.asarray(rgb))]
    s_t = _t(sig).requires_grad_()
    r_t = _t(rgb).requires_grad_()
    outs = composite_rays(s_t, r_t, _t(dt), _t(dd), _t(mask))
    sum((o * _t(gi)).sum() for o, gi in zip(outs, g)).backward()
    plain = composite_rays_bwd_plain(_t(sig), _t(rgb), _t(dt), _t(dd),
                                     _t(mask), *(_t(gi) for gi in g))
    for got, w, name in ((s_t.grad, want[0], "sigma"),
                         (r_t.grad, want[1], "rgb"),
                         (plain[0], want[0], "sigma (bwd_plain)"),
                         (plain[1], want[1], "rgb (bwd_plain)")):
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(got.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
    # masked-out slots get nothing
    assert not s_t.grad.numpy()[~mask].any()
    assert not r_t.grad.numpy()[~mask].any()


# K3's hard inputs (chip_smoke.py's `k3_hard_inputs`, the ones the card
# holds K3 to against the plain version)
K3_CASES = ["counts", "counts_16", "opaque", "stop", "stop_16", "eval_tail",
            "empty"]


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("name", K3_CASES)
def test_composite_compact_hard_inputs_match_jax(name, early_stop):
    import chip_smoke

    sig, rgb, dt, t_cum, rid, valid, n = chip_smoke.k3_hard_inputs()[name]
    got = composite_rays_compact(_t(sig), _t(rgb), _t(dt), _t(t_cum),
                                 _t(rid), _t(valid), n, early_stop=early_stop)
    if name == "empty":  # no slot: every ray composites nothing
        assert sig.shape == (0,) and got[3].shape == (0,)
        assert all(not o.any() for o in got[:3])
    want = j_compact_comp(jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(dt),
                          jnp.asarray(t_cum), jnp.asarray(rid),
                          jnp.asarray(valid), n, early_stop=early_stop)
    for g, w, out in zip(got, want, ("weights_sum", "depth", "image",
                                     "weights")):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=COMP_TOL,
                                   atol=COMP_TOL, err_msg=out)
    w = got[3].numpy()
    counts = np.bincount(rid[valid], minlength=n)
    if name.startswith("counts"):
        assert sorted(counts[counts > 0]) == [1, 15, 16, 17, 31, 32, 33, 256,
                                              1024]
        # the long rays stay above T = 1e-4: early stop changes nothing
        assert (w[rid == 9] > 0).all()
    if name.startswith("stop"):
        # ray r's first stopped slot is k: its weight and all later ones
        # are zero under early stop and not without it
        for r, k in enumerate((7, 8, 15, 16, 17, 31, 32, 33)):
            wr = w[valid & (rid == r)]
            assert (wr[:k] > 0).all()
            assert (wr[k:] == 0).all() == early_stop and wr[k:].any() != \
                early_stop
    if name == "opaque":  # alpha = 1: T is 0 after it
        assert (w[10] > 0) and not w[11:40].any()
        assert w[40] > 0 and not w[41:80].any()
    if name == "eval_tail":
        assert not valid[-200:].any() and not rid[-200:].any()
        assert not w[~valid].any()


def test_k3_lanes_plan():
    """K3's lanes per ray from the mean budget per ray: 16 up to 16 slots
    per ray, 32 above (k3_hard_inputs has cases of both)."""
    import chip_smoke
    from pvd_tpu_torch.ops.composite import k3_lanes

    assert k3_lanes(65_536, 4096) == 16  # serving, 1x rung
    assert k3_lanes(65_537, 4096) == 32
    assert k3_lanes(262_144, 4096) == 32  # 4x
    assert k3_lanes(1_048_576, 4096) == 32  # 16x
    assert k3_lanes(131_072, 8192) == 16  # the exact teacher's budget
    assert k3_lanes(24_576, 4096) == 16  # 6 samples per ray
    assert k3_lanes(0, 8) == 16
    lanes = {name: k3_lanes(len(case[0]), case[-1])
             for name, case in chip_smoke.k3_hard_inputs().items()}
    assert lanes == {"counts": 32, "counts_16": 16, "opaque": 32,
                     "stop": 32, "stop_16": 16, "eval_tail": 32,
                     "empty": 16}


@pytest.mark.parametrize("name", K3_CASES)
def test_composite_compact_grad_matches_jax_on_k6_hard_inputs(name):
    """d(sigma), d(rgb) of the compacted composite (autograd through the
    plain version, what the card holds K6 to) against JAX's autodiff on
    K6's hard inputs (`chip_smoke.k6_hard_inputs`: K3's streams with random
    upstream gradients of all four outputs), to GRAD_TOL; slots no ray
    owns get nothing."""
    import jax

    import chip_smoke

    sig, rgb, dt, t_cum, rid, valid, n, gs = chip_smoke.k6_hard_inputs()[name]
    assert [g.shape for g in gs] == [(n,), (n,), (n, 3), (sig.shape[0],)]

    def j_loss(s, r):
        outs = j_compact_comp(s, r, jnp.asarray(dt), jnp.asarray(t_cum),
                              jnp.asarray(rid), jnp.asarray(valid), n)
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs))

    want = [np.asarray(w) for w in jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(sig), jnp.asarray(rgb))]
    s_t = _t(sig).requires_grad_()
    r_t = _t(rgb).requires_grad_()
    outs = composite_rays_compact(s_t, r_t, _t(dt), _t(t_cum), _t(rid),
                                  _t(valid), n)
    sum((o * _t(g)).sum() for o, g in zip(outs, gs)).backward()
    for got, w, out in ((s_t.grad, want[0], "sigma"),
                        (r_t.grad, want[1], "rgb")):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=out)
    assert not s_t.grad.numpy()[~valid].any()
    assert not r_t.grad.numpy()[~valid].any()
    if name != "empty":
        assert np.abs(want[0]).max() > 0


def test_k6_lanes_plan():
    """K6 walks each ray with K3's lane groups (`k3_lanes`): 16 lanes at
    every training shape, and both widths among its hard inputs."""
    import chip_smoke
    from pvd_tpu_torch.ops.composite import k3_lanes

    assert k3_lanes(131_072, 8192) == 16  # the distill / exact teacher
    assert k3_lanes(65_536, 4096) == 16  # the A/B teacher's budget
    assert k3_lanes(24_576, 4096) == 16  # A/B stage 3
    lanes = {k3_lanes(len(case[0]), case[6])
             for case in chip_smoke.k6_hard_inputs().values()}
    assert lanes == {16, 32}


# K9's hard inputs (chip_smoke.py's `k9_hard_inputs`, the ones the card
# holds K9 to against its plain version)
K9_CASES = ["S1", "S15", "S16", "S17", "S31", "S32", "S33", "S64", "S96",
            "S130", "S96_wide", "S130_wide", "scattered", "all_masked", "last_only", "opaque_first",
            "dt_zero", "zero_g_ws", "zero_g_depth", "zero_g_image",
            "zero_g_weights"]


@pytest.mark.parametrize("name", K9_CASES)
def test_composite_padded_grad_matches_jax_on_k9_hard_inputs(name):
    """d(sigma), d(rgb) of the padded composite through
    composite_rays_bwd_plain (what the card holds K9 to) against JAX's
    autodiff of composite_rays on K9's hard inputs, to GRAD_TOL; masked
    slots get nothing."""
    import jax

    import chip_smoke
    from pvd_tpu_torch.ops.composite import composite_rays_bwd_plain

    cases = chip_smoke.k9_hard_inputs()
    assert sorted(cases) == sorted(K9_CASES)
    sig, rgb, dt, dd, mask, gs = cases[name]
    N, S = sig.shape
    assert [g.shape for g in gs] == [(N,), (N,), (N, 3), (N, S)]

    def j_loss(s, r):
        outs = j_composite_rays(s, r, jnp.asarray(dt), jnp.asarray(dd),
                                jnp.asarray(mask))
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs))

    want = [np.asarray(w) for w in jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(sig), jnp.asarray(rgb))]
    got = composite_rays_bwd_plain(_t(sig), _t(rgb), _t(dt), _t(dd),
                                   _t(mask), *(_t(g) for g in gs))
    for g, w, out in ((got[0], want[0], "sigma"), (got[1], want[1], "rgb")):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=out)
    assert not got[0].numpy()[~mask].any()
    assert not got[1].numpy()[~mask].any()
    if name == "all_masked":
        assert not mask.any()
    elif name == "dt_zero":  # alpha = 0 everywhere: no gradient at all
        assert not want[0].any() and not want[1].any()
    else:
        assert np.abs(want[0]).max() > 0
    if name == "opaque_first":  # T = 0 after an opaque first slot
        rows = mask[:, 0] & mask[:, 1]
        assert rows.any() and not got[1].numpy()[rows, 1:].any()
    if name == "scattered":
        assert 0.08 < mask.mean() < 0.14


# K8's hard inputs (chip_smoke.py's `k8_hard_inputs`: K9's and a T that
# crosses 1e-4 inside a tile, the ones the card holds K8 to)
K8_CASES = K9_CASES + ["t_crosses"]
# cases whose alphas round alike in both packages (none, 0 or 1): there
# XLA's exp and torch's cannot part, so every output is equal
K8_EXACT = ("all_masked", "opaque_first", "dt_zero")


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("name", K8_CASES)
def test_composite_padded_matches_jax_on_k9_hard_inputs(name, early_stop):
    """composite_rays_plain (what the card holds K8 to) against JAX's
    composite_rays (pvd_tpu/ops/composite.py:97) on K8's hard inputs, with
    early stop off and on: equal where the alphas are (K8_EXACT); else
    within COMP_TOL, as in test_composite_padded_matches_jax, because the
    two packages' exps can part by an ulp (measured up to 3.6e-7 on these
    cases); masked slots weigh 0 in both, and under early stop every slot
    whose T is under 1e-4 does too."""
    import chip_smoke
    from pvd_tpu_torch.ops.composite import composite_rays_plain

    cases = chip_smoke.k8_hard_inputs()
    assert sorted(cases) == sorted(K8_CASES)
    arrays = cases[name]
    mask = arrays[4]
    want = [np.asarray(w) for w in j_composite_rays(
        *(jnp.asarray(a) for a in arrays), early_stop=early_stop)]
    got = [g.numpy() for g in composite_rays_plain(
        *(_t(a) for a in arrays), early_stop=early_stop)]
    for g, w, out in zip(got, want, ("weights_sum", "depth", "image",
                                     "weights")):
        assert g.shape == w.shape and np.isfinite(g).all()
        if name in K8_EXACT:
            np.testing.assert_array_equal(g, w, err_msg=out)
        else:
            np.testing.assert_allclose(g, w, rtol=COMP_TOL, atol=COMP_TOL,
                                       err_msg=out)
    assert not got[3][~mask].any() and not want[3][~mask].any()
    if name == "t_crosses":
        sig, _, dt, _, _ = arrays
        alpha = (1.0 - np.exp(-sig.astype(np.float64) * dt)) * mask
        T = np.cumprod(np.c_[np.ones(len(sig)), 1.0 - alpha[:, :-1]], 1)
        late = T < 0.5e-4  # well past the cut, clear of rounding
        cross = (T < 1e-4).argmax(1)
        assert ((cross % 32) != 0).mean() > 0.9  # inside a tile
        if early_stop:
            assert not got[3][late].any() and not want[3][late].any()
        else:
            assert got[3][late & mask].all()


def test_k9_rows():
    """`chip_smoke.k9_rows`, the row statistics logged beside K9's times:
    rows with a valid slot, their mean and largest valid count, 32-slot
    tiles holding one, and whether each row's valid slots are a prefix."""
    import chip_smoke

    mask = torch.zeros(4, 96, dtype=torch.uint8)
    mask[0, :2] = 1
    mask[2, :40] = 1
    mask[3, :96] = 1
    assert chip_smoke.k9_rows(mask) == {"rows": 3, "mean": 46.0,
                                        "longest": 96, "tiles": 6,
                                        "prefix": True}
    mask[1, 33] = 1
    got = chip_smoke.k9_rows(mask)
    assert (got["rows"], got["tiles"], got["prefix"]) == (4, 7, False)
    assert chip_smoke.k9_rows(torch.zeros(3, 1, dtype=torch.uint8)) == {
        "rows": 0, "mean": 0.0, "longest": 0, "tiles": 0, "prefix": True}
