"""X2, the f32/bf16 throughput probe (photo_slam_tpu_torch/tools/
exp_vpu_dtype.py): the plain chains against the JAX tool
tools/exp_vpu_dtype.py's kernels run interpreted on the CPU, on one
[64, 1024] block of each type. make_kernel is wrapped in an interpreted
pallas_call; run_exp's inline kernel is caught by a pallas_call shim that
records it."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from photo_slam_tpu_torch.tools import exp_vpu_dtype as tx2
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_exp_blend_vec import tool_module

jx2 = tool_module("exp_vpu_dtype")
PAIRS = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def block(scale):
    return (np.random.RandomState(0).rand(1, tx2.ROWS, tx2.P) * scale).astype(
        np.float32)


def run_block(kernel, jdtype, x):
    """One [1, 64, 1024] block through `kernel` in an interpreted
    pallas_call; float32 numpy out."""
    spec = pl.BlockSpec((1, tx2.ROWS, tx2.P), lambda g: (g, 0, 0))
    f = pl.pallas_call(kernel, grid=(1,), in_specs=[spec], out_specs=spec,
                       out_shape=jax.ShapeDtypeStruct(x.shape, jdtype),
                       interpret=True)
    return np.asarray(f(jnp.asarray(x, jdtype)).astype(jnp.float32))


def plain(fn, tdtype, x, *args):
    return fn(torch.from_numpy(x).to(tdtype), *args).float().numpy()


def assert_close(got, want, tdtype):
    """float32: within 1e-6 relative; bf16: within 2 units in the last
    place of the JAX value."""
    assert np.isfinite(want).all() and np.isfinite(got).all()
    if tdtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= 2 * ulp).all()


@pytest.mark.parametrize("tdtype,jdtype", PAIRS)
def test_chain_matches_make_kernel(tdtype, jdtype, monkeypatch):
    """A short chain (INNER 4, read by make_kernel when it is traced) stays
    finite and agrees; at the tool's INNER (256) the chain overflows and
    only the NaN pattern can agree."""
    x = block(0.001)
    monkeypatch.setattr(jx2, "INNER", 4)
    want = run_block(jx2.make_kernel(jdtype), jdtype, x)
    assert_close(plain(tx2.chain, tdtype, x, 4), want, tdtype)
    monkeypatch.setattr(jx2, "INNER", tx2.INNER)
    want = run_block(jx2.make_kernel(jdtype), jdtype, x)
    got = plain(tx2.chain, tdtype, x)
    assert np.isnan(want).mean() > 0.5
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[fin], want[fin])


@pytest.mark.parametrize("tdtype,jdtype", PAIRS)
def test_exp_chain_matches_run_exp_kernel(tdtype, jdtype, monkeypatch):
    recorded = []

    def record(kernel, **kw):
        recorded.append(kernel)
        return lambda x: x

    ns = types.SimpleNamespace(**vars(pl))
    ns.pallas_call = record
    monkeypatch.setattr(jx2, "pl", ns)
    jx2.run_exp(jdtype, num_blocks=1, reps=1)
    assert len(recorded) == 1
    x = block(1.0)
    want = run_block(recorded[0], jdtype, x)
    assert_close(plain(tx2.exp_chain, tdtype, x), want, tdtype)


def test_wrappers_raise_off_the_cpu_and_main_runs_on_it(capsys):
    x = torch.from_numpy(block(0.001))
    before = (tx2.chain.launches, tx2.exp_chain.launches)
    assert torch.equal(tx2.chain(x, 3), tx2.chain_plain(x, 3))
    assert torch.equal(tx2.exp_chain(x), tx2.exp_chain_plain(x))
    assert (tx2.chain.launches, tx2.exp_chain.launches) == before
    for bad in (x.to("meta"), x.half().to("meta")):
        with pytest.raises(ValueError):
            tx2.chain(bad)
        with pytest.raises(ValueError):
            tx2.exp_chain(bad)
    tx2.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("Tops/s") == 2 and out.count("Gexp/s") == 2
