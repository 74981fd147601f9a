"""X4, the 16x16 quadrant blend (photo_slam_tpu_torch/tools/exp_blend16.py),
against the JAX tool tools/exp_blend16.py run interpreted on the CPU: the
forward and backward plain versions on a seeded quadrant table (the JAX
kernels on the slab that repeats each of its rows twice), the plain
backward against autograd through the plain forward in float64, and the
whole 16 px path (binning at 16, the quadrant table, Blend16, img16, the
tool's loss) on a small scene against the same pipeline built from the JAX
functions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.ops.binning import bin_gaussians as jbin
from photo_slam_tpu_torch.ops.preprocess import preprocess, tight_extents
from photo_slam_tpu_torch.ops.tiled import pack_features
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices
from photo_slam_tpu_torch.tools import exp_blend16 as tx4
from photo_slam_tpu_torch.tools.bench_room import RoomView
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_exp_blend_vec import assert_blend_close, interpret, tool_module

jx4 = tool_module("exp_blend16")
K = 64
COUNTS = (64, 37, 0, 12)   # per quadrant of the one block


def random_slab(counts, k, seed, nb=1):
    """[nb, K, 8, 16] slab with quadrant-local means scattered around each
    quadrant, opacities high enough that many pixels stop early, 0.5 in
    the rows past each count (the JAX kernel reads them inside its last
    group), each quadrant row repeated on rows 2q, 2q + 1."""
    rng = np.random.RandomState(seed)
    tab = np.full((nb, k, 4, 16), 0.5, np.float32)
    tab[..., 9:] = 0.0
    for b in range(nb):
        for q in range(4):
            c = counts[4 * b + q]
            a = rng.rand(c) * 0.08 + 0.005
            cc = rng.rand(c) * 0.08 + 0.005
            tab[b, :c, q, 0] = rng.rand(c) * 24 - 4
            tab[b, :c, q, 1] = rng.rand(c) * 24 - 4
            tab[b, :c, q, 2] = a
            tab[b, :c, q, 3] = (rng.rand(c) - 0.5) * np.sqrt(a * cc)
            tab[b, :c, q, 4] = cc
            tab[b, :c, q, 5] = rng.rand(c) * 0.6 + 0.39
            tab[b, :c, q, 6:9] = rng.rand(c, 3)
    return np.repeat(tab, 2, axis=2), tab


def cotangents(nb, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(nb, 3, 8, 128).astype(np.float32),
            rng.randn(nb, 8, 128).astype(np.float32))


def assert_rows_match(got, want, counts, rtol=1e-4):
    """Per lane, the max abs error within rtol of the lane's max; lanes
    9-15 and rows past each quadrant's count exact zeros in `got`."""
    got, want = np.asarray(got), np.asarray(want)
    for lane in range(9):
        scale = np.abs(want[..., lane]).max()
        assert scale > 0, f"lane {lane} all zero"
        err = np.abs(got[..., lane] - want[..., lane]).max()
        assert err <= rtol * scale, f"lane {lane}: {err} > {rtol} x {scale}"
    assert (got[..., 9:] == 0).all()
    cnt = np.asarray(counts).reshape(-1, 4)                 # [nb, 4]
    rows = np.arange(got.shape[1])[None, :, None] >= cnt[:, None, :]
    assert (got[rows] == 0).all()


@pytest.fixture(scope="module")
def jax_forward():
    """The JAX forward on the seeded slab, interpreted (shared by the
    forward and backward tests); the port takes the table `tab`."""
    mp = pytest.MonkeyPatch()
    interpret(mp, jx4)
    try:
        slab, tab = random_slab(COUNTS, K, seed=0)
        counts = np.asarray(COUNTS, np.int32)
        out = jx4.blend16_call(jnp.asarray(slab), jnp.asarray(counts), 1)
        yield slab, tab, counts, [np.array(x) for x in out]
    finally:
        mp.undo()


def test_forward_plain_matches_jax(jax_forward):
    _, tab, counts, want = jax_forward
    before = tx4.blend16_fwd.launches
    got = tx4.blend16_fwd(torch.from_numpy(tab), torch.from_numpy(counts), 1)
    assert tx4.blend16_fwd.launches == before
    assert_blend_close(got, want)
    # Quadrant 2 has no entries; the others stop early at many pixels.
    t = want[1].reshape(4, 256)
    assert (t[2] == 1).all() and (t[0] < 1e-3).mean() > 0.1


def test_backward_plain_matches_jax(jax_forward, monkeypatch):
    interpret(monkeypatch, jx4)
    slab, tab, counts, (_, final_t, n_contrib) = jax_forward
    g_c, g_t = cotangents(1, 1)
    want = jx4.blend16_bwd_call(*(jnp.asarray(x) for x in (
        slab, tab, counts, final_t, n_contrib, g_c, g_t)), 1)
    got = tx4.blend16_bwd(*(torch.tensor(x) for x in (
        tab, counts, final_t, n_contrib, g_c, g_t)), 1)
    assert got.shape == (1, K, 4, 16)
    assert_rows_match(got.numpy(), want, counts)


def test_backward_plain_is_the_gradient_of_the_forward():
    """In float64, blend16_bwd_plain equals autograd through
    blend16_fwd_plain (g_T nonzero), over two blocks."""
    counts = np.asarray((64, 37, 0, 12, 5, 64, 50, 21), np.int32)
    _, tab = random_slab(counts, K, seed=2, nb=2)
    g_c, g_t = (torch.from_numpy(x).double() for x in cotangents(2, 3))
    d16c = torch.from_numpy(tab).double().requires_grad_(True)
    cnt = torch.from_numpy(counts)
    color, final_t, n_contrib = tx4.blend16_fwd_plain(d16c, cnt, 2)
    (want,) = torch.autograd.grad((color * g_c).sum() + (final_t * g_t).sum(),
                                  d16c)
    got = tx4.blend16_bwd_plain(d16c.detach(), cnt, final_t.detach(),
                                n_contrib, g_c, g_t, 2)
    assert got.dtype == torch.float64
    assert_rows_match(got.numpy(), want.numpy(), counts, rtol=1e-10)


def test_wrappers_raise_off_the_cpu():
    _, tab = random_slab(COUNTS, K, seed=0)
    t = torch.from_numpy(tab)
    c = torch.tensor(COUNTS, dtype=torch.int32)
    for bad in (t.to("meta"), t.double().to("meta")):
        with pytest.raises(ValueError):
            tx4.blend16_fwd(bad, c.to("meta"), 1)
    pix = torch.zeros((1, 8, 128)).to("meta")
    with pytest.raises(ValueError):
        tx4.blend16_bwd(t.to("meta"), c.to("meta"), pix, pix.int(),
                        torch.zeros((1, 3, 8, 128)).to("meta"), pix, 1)


# ---- the whole 16 px path on a small scene ----------------------------------

W = H = 32   # one 32 px block of four quadrants


def small_view(n=50, seed=4):
    """~50 Gaussians in front of the camera, a few px wide, through the
    port's preprocess at 32x32."""
    rng = np.random.RandomState(seed)
    xyz = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-1.0, 1.0, n),
                    rng.uniform(2.0, 4.0, n)], 1).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = torch.from_numpy(rng.uniform(0.3, 0.9, n).astype(np.float32))
    rgb = torch.from_numpy(rng.rand(n, 3).astype(np.float32))
    fovx = 1.0
    cam = build_camera_matrices(np.eye(3), np.zeros(3), 0.01, 100.0, fovx,
                                fovx, device="cpu")
    tan = float(np.tan(fovx / 2))
    prep = preprocess(torch.from_numpy(xyz), torch.from_numpy(scales),
                      torch.from_numpy(quats), cam.viewmatrix, cam.full_proj,
                      cam.cam_center, W, H, tan, tan, colors_precomp=rgb)
    return RoomView(prep=prep, opac=opac,
                    extents=tight_extents(prep.conics, opac, prep.radii),
                    feat=pack_features(prep, opac), width=W, height=H)


def jax_path16(view, monkeypatch):
    """The tool's 16 px path (:349-385, 433-483) from the JAX functions on
    the port's preprocessed inputs, with blend16_call and blend16_bwd_call
    interpreted: (image, feat gradient of the tool's loss). The feat
    gather is entry_gather's forward, feat[max(id, 0) // k_dup]: the JAX
    entry_gather's transpose rounds its rows to bf16, which the port does
    not copy (ROADMAP Queue 3)."""
    interpret(monkeypatch, jx4)
    p = view.prep
    b16 = jbin(*(jnp.asarray(x.numpy()) for x in (
        p.means2d, p.depths, p.radii, p.visible)), W, H, tile=16,
        max_tiles_per_gaussian=8, max_per_tile=K,
        extents=jnp.asarray(view.extents.numpy()))
    assert int(b16.num_overflow) == 0 and int(b16.num_clipped) == 0
    gx16, gy16, bx, by, nb = 2, 2, 1, 1, 1
    perm = np.zeros(4, np.int32)
    for q in range(4):
        perm[q] = (q // 2) * gx16 + q % 2
    lists_p = b16.tile_lists[jnp.asarray(perm)]
    counts_pp = b16.tile_counts[jnp.asarray(perm)]
    ox = (16.0 * (perm % gx16)).astype(np.float32)
    oy = (16.0 * (perm // gx16)).astype(np.float32)
    shift = jnp.stack([jnp.asarray(ox), jnp.asarray(oy)], 1)

    @jax.custom_vjp
    def blend16_t(d16c):
        return jx4.blend16_call(jnp.repeat(d16c, 2, axis=2), counts_pp, nb)

    def b16_fwd(d16c):
        slab_ = jnp.repeat(d16c, 2, axis=2)
        out = jx4.blend16_call(slab_, counts_pp, nb)
        return out, (slab_, out[1], out[2])

    def b16_bwd(res, cts):
        slab_, ft, nc = res
        gc, g_t, _ = cts
        return (jx4.blend16_bwd_call(slab_, slab_[:, :, ::2, :], counts_pp,
                                     ft, nc, gc, g_t, nb),)

    blend16_t.defvjp(b16_fwd, b16_bwd)

    def jimg16(color):
        x = color.reshape(by, bx, 3, 4, 256)
        x = x.reshape(by, bx, 3, 2, 2, 16, 16)
        x = x.transpose(2, 0, 3, 5, 1, 4, 6).reshape(3, by * 32, bx * 32)
        return x[:, :H, :W]

    weights = jnp.asarray(tx4.loss_weights(W, H, "cpu").numpy())

    def loss16(f):
        d = f[jnp.where(lists_p >= 0, lists_p // 8, 0)]
        d = d.at[:, :, 0:2].add(-shift[:, None, :])
        d16c = d.reshape(nb, 4, K, 16).transpose(0, 2, 1, 3)
        c, t, _ = blend16_t(d16c)
        return jnp.sum(jimg16(c) * weights) + 0.3 * jnp.sum(t), jimg16(c)

    grad, image = jax.grad(loss16, has_aux=True)(
        jnp.asarray(view.feat.detach().numpy()))
    return np.asarray(image), np.asarray(grad), np.asarray(counts_pp)


def test_path16_matches_jax(monkeypatch):
    view = small_view()
    path = tx4.bin16(view, k_dup=8, max_per_tile=K)
    assert path.num_blocks == 1 and int(path.binning.num_overflow) == 0
    feat = view.feat.detach().clone().requires_grad_(True)
    d16c = tx4.quadrant_table(feat, path)
    color, _, _ = tx4.Blend16.apply(d16c, path.counts_q)
    image = tx4.img16(color, path.bx, path.by, W, H)
    weights = tx4.loss_weights(W, H, "cpu")
    (grad,) = torch.autograd.grad(tx4.loss16(feat, path, weights, W, H),
                                  feat)

    j_image, j_grad, j_counts = jax_path16(view, monkeypatch)
    np.testing.assert_array_equal(path.counts_q.numpy(), j_counts)
    assert (j_counts > 0).all() and float(image.detach().mean()) > 0.05
    np.testing.assert_allclose(image.detach().numpy(), j_image, atol=1e-5,
                               rtol=0)
    for lane in range(9):
        scale = np.abs(j_grad[:, lane]).max()
        assert scale > 0
        err = np.abs(grad[:, lane].numpy() - j_grad[:, lane]).max()
        assert err <= 1e-4 * scale, f"lane {lane}: {err} vs max {scale}"
    assert (grad[:, 9:] == 0).all()
