"""Kernels K1 and K2 of the PyTorch port (ops/deform_attn.py) against the
JAX package.

On the CPU the port's wrapper runs K1's plain version, and autograd of it
is K2's plain version (``deform_attn_bwd_reference``). They are held here
to the JAX composite ``_xla_reference`` (and ``jax.vjp`` of it) and to the
TPU kernels in Pallas interpret mode: forward v1, v3 and v4 layouts, and
the fused backward ``fused_deform_attention_bwd_v2`` in both its layouts
(``DAT_TPU_BWD_LAYOUT`` v2 and v4), in float32 to 1e-5: the same float32
arithmetic, summed in another order. The CUDA kernels themselves are held
to the plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dat_segmentation_tpu.ops.pallas.deform_attn import (
    _xla_reference,
    fused_deform_attention,
    fused_deform_attention_fwd,
    fused_deform_attention_v2,
)
from dat_segmentation_tpu_torch.ops.deform_attn import (
    deform_attn,
    deform_attn_bwd,
    deform_attn_bwd_reference,
    deform_attn_reference,
    rpe_bias,
)

ATOL = 1e-5  # float32 on both sides; only the order of the sums differs
torch.set_num_threads(2)  # as tests/torch_port_helpers.py: one of several xdist workers


def _inputs(B=2, g=2, h_g=2, hc=16, H=16, W=8, Ns=16, th=15, tw=15, seed=0,
            pos_range=1.0):
    rng = np.random.RandomState(seed)
    Cg = h_g * hc
    q = rng.randn(B * g, H, W, Cg).astype(np.float32) * 0.5
    k = rng.randn(B * g, Ns, Cg).astype(np.float32) * 0.5
    v = rng.randn(B * g, Ns, Cg).astype(np.float32) * 0.5
    pos = rng.uniform(-pos_range, pos_range, (B * g, Ns, 2)).astype(np.float32)
    table = rng.randn(g, h_g, th, tw).astype(np.float32) * 0.1
    return q, k, v, pos, table


def _port(arrays, **kw):
    g = arrays[4].shape[0]
    scale = (arrays[0].shape[-1] // arrays[4].shape[1]) ** -0.5
    with torch.no_grad():
        out = deform_attn(*map(torch.from_numpy, arrays), n_groups=g, scale=scale, **kw)
    return out.numpy()


@pytest.mark.parametrize(
    "shape",
    [
        dict(),
        dict(H=8, W=16, Ns=25),  # rectangular, odd Ns
        dict(g=1, h_g=4, hc=8),  # one group, more heads
        dict(th=21, tw=9),  # asymmetric table
        dict(pos_range=1.2),  # pos outside [-1, 1]: table taps out of range
        dict(pos_range=3.0),  # taps wholly outside the table: no bias there
        dict(B=1, g=2, h_g=2, hc=32, H=16, W=16, Ns=256, th=13, tw=13),  # stage 3
    ],
)
def test_plain_matches_xla_reference(shape):
    arrays = _inputs(**shape)
    g = arrays[4].shape[0]
    scale = (arrays[0].shape[-1] // arrays[4].shape[1]) ** -0.5
    ref = _xla_reference(*map(jnp.asarray, arrays), n_groups=g, scale=scale)
    np.testing.assert_allclose(_port(arrays), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw", [(28, 28), (7, 7), (28, 14)])
def test_plain_padded_queries_match_xla_reference(hw):
    """Queries zero-padded to 8-multiples with the true sizes as hn/wn
    give the unpadded result on the real rows."""
    H, W = hw
    q, k, v, pos, table = _inputs(H=H, W=W, Ns=16, pos_range=1.2)
    g = table.shape[0]
    scale = (q.shape[-1] // table.shape[1]) ** -0.5
    ref = _xla_reference(*map(jnp.asarray, (q, k, v, pos, table)), n_groups=g, scale=scale)
    Hp, Wp = -(-H // 8) * 8, -(-W // 8) * 8
    qp = np.pad(q, ((0, 0), (0, Hp - H), (0, Wp - W), (0, 0)))
    got = _port((qp, k, v, pos, table), hn=H, wn=W)[:, :H, :W]
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    ref_p = _xla_reference(
        *map(jnp.asarray, (qp, k, v, pos, table)), n_groups=g, scale=scale, hn=H, wn=W
    )
    np.testing.assert_allclose(
        _port((qp, k, v, pos, table), hn=H, wn=W), np.asarray(ref_p), rtol=0, atol=ATOL
    )


@pytest.mark.parametrize(
    "version,shape",
    [
        (4, dict()),
        (4, dict(H=8, W=16, Ns=25, pos_range=1.2)),
        (3, dict(B=1, g=1, h_g=2, hc=8, H=2, W=128, Ns=16, th=15, tw=15)),
    ],
)
def test_plain_matches_pallas_interpret(version, shape):
    """The TPU kernel's v4 (query-major) and v3 (W % 128 == 0) layouts."""
    arrays = _inputs(**shape)
    g = arrays[4].shape[0]
    scale = (arrays[0].shape[-1] // arrays[4].shape[1]) ** -0.5
    ref = fused_deform_attention_v2(
        *map(jnp.asarray, arrays), n_groups=g, scale=scale, interpret=True,
        version=version,
    )
    np.testing.assert_allclose(_port(arrays), np.asarray(ref), rtol=0, atol=ATOL)


def test_plain_padded_matches_pallas_v4_interpret():
    q, k, v, pos, table = _inputs(H=14, W=14, Ns=16)
    qp = np.pad(q, ((0, 0), (0, 2), (0, 2), (0, 0)))
    g = table.shape[0]
    scale = (q.shape[-1] // table.shape[1]) ** -0.5
    ref = fused_deform_attention_v2(
        *map(jnp.asarray, (qp, k, v, pos, table)), n_groups=g, scale=scale,
        interpret=True, version=4, hn=14, wn=14,
    )
    got = _port((qp, k, v, pos, table), hn=14, wn=14)
    np.testing.assert_allclose(got[:, :14, :14], np.asarray(ref)[:, :14, :14], rtol=0, atol=ATOL)


def test_plain_matches_round1_pallas_interpret():
    """``fused_deform_attention_fwd`` (the round-1 layout, TPU kernel v1)
    computes the same function without hn/wn."""
    arrays = _inputs(H=8, W=8, Ns=9)
    g = arrays[4].shape[0]
    scale = (arrays[0].shape[-1] // arrays[4].shape[1]) ** -0.5
    ref = fused_deform_attention_fwd(
        *map(jnp.asarray, arrays), n_groups=g, scale=scale, interpret=True
    )
    np.testing.assert_allclose(_port(arrays), np.asarray(ref), rtol=0, atol=ATOL)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    arrays = [torch.from_numpy(a) for a in _inputs()]
    before = deform_attn.launches
    with torch.no_grad():
        got = deform_attn(*arrays, n_groups=2, scale=0.25)
        ref = deform_attn_reference(*arrays, n_groups=2, scale=0.25)
    assert torch.equal(got, ref)
    assert deform_attn.launches == before


# ---------------------------------------------------------------- K2 ------

GRADS = ("dq", "dk", "dv", "dpos", "dtable")


def _dout(q, seed=11):
    return np.random.RandomState(seed).randn(*q.shape).astype(np.float32)


def _port_grads(arrays, dout, **kw):
    g = arrays[4].shape[0]
    scale = (arrays[0].shape[-1] // arrays[4].shape[1]) ** -0.5
    grads = deform_attn_bwd_reference(
        *map(torch.from_numpy, arrays), torch.from_numpy(dout), n_groups=g, scale=scale, **kw
    )
    return [t.numpy() for t in grads]


def _assert_grads(got, ref, what=""):
    for name, a, b in zip(GRADS, got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL, err_msg=f"{what} {name}")


_BWD_SHAPES = [
    dict(),
    dict(H=8, W=16, Ns=25, pos_range=1.2),  # odd Ns; pos outside [-1, 1]
    dict(B=1, g=2, h_g=2, hc=8, H=8, W=8, Ns=64, th=13, tw=13),  # a narrow stage's table
]


@pytest.mark.parametrize("layout", ["v2", "v4"])
@pytest.mark.parametrize("shape", _BWD_SHAPES)
def test_plain_grads_match_pallas_bwd_interpret(shape, layout, monkeypatch):
    """The gradients of the port's plain version against ``jax.vjp`` of
    ``fused_deform_attention(interpret=True, fused_bwd=True)``: the TPU
    kernel K2 interpreted, in its sample-major (v2) and query-major (v4)
    layouts."""
    monkeypatch.setenv("DAT_TPU_BWD_LAYOUT", layout)
    arrays = _inputs(**shape)
    g = arrays[4].shape[0]
    scale = (arrays[0].shape[-1] // arrays[4].shape[1]) ** -0.5
    dout = _dout(arrays[0])
    _, vjp = jax.vjp(lambda *a: fused_deform_attention(*a, g, scale, True, 2, True),
                     *map(jnp.asarray, arrays))
    _assert_grads(_port_grads(arrays, dout), vjp(jnp.asarray(dout)), layout)


@pytest.mark.parametrize("shape", _BWD_SHAPES)
def test_plain_grads_match_xla_reference_vjp(shape):
    arrays = _inputs(**shape)
    g = arrays[4].shape[0]
    scale = (arrays[0].shape[-1] // arrays[4].shape[1]) ** -0.5
    dout = _dout(arrays[0])
    _, vjp = jax.vjp(lambda *a: _xla_reference(*a, n_groups=g, scale=scale),
                     *map(jnp.asarray, arrays))
    _assert_grads(_port_grads(arrays, dout), vjp(jnp.asarray(dout)))


def test_plain_grads_padded_queries_match_pallas_bwd_interpret():
    """Queries padded 14 -> 16 with hn = wn = 14, zero cotangent on the pad
    rows: every gradient equals the interpreted TPU kernel's."""
    q, k, v, pos, table = _inputs(H=14, W=14, Ns=16, pos_range=1.2)
    qp = np.pad(q, ((0, 0), (0, 2), (0, 2), (0, 0)))
    dout = np.pad(_dout(q), ((0, 0), (0, 2), (0, 2), (0, 0)))
    g = table.shape[0]
    scale = (q.shape[-1] // table.shape[1]) ** -0.5
    arrays = (qp, k, v, pos, table)
    _, vjp = jax.vjp(lambda *a: fused_deform_attention(*a, g, scale, True, 0, True, 14, 14),
                     *map(jnp.asarray, arrays))
    _assert_grads(_port_grads(arrays, dout, hn=14, wn=14), vjp(jnp.asarray(dout)))


def test_bwd_reference_is_autograd_of_the_plain_forward():
    """``deform_attn_bwd_reference`` equals autograd through ``deform_attn``
    on the CPU, which is how a CPU model trains."""
    arrays = _inputs(pos_range=1.2)
    dout = torch.from_numpy(_dout(arrays[0]))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    deform_attn(*leaves, n_groups=2, scale=0.25).backward(dout)
    ref = deform_attn_bwd_reference(*map(torch.from_numpy, arrays), dout, n_groups=2, scale=0.25)
    for name, leaf, r in zip(GRADS, leaves, ref):
        assert torch.equal(leaf.grad, r), name


def test_cpu_bwd_wrapper_is_the_plain_version_and_counts_no_launch():
    arrays = [torch.from_numpy(a) for a in _inputs()]
    dout = torch.from_numpy(_dout(arrays[0]))
    before = deform_attn_bwd.launches
    got = deform_attn_bwd(*arrays, dout, n_groups=2, scale=0.25)
    ref = deform_attn_bwd_reference(*arrays, dout, n_groups=2, scale=0.25)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert deform_attn_bwd.launches == before


def test_rpe_bias_zero_outside_the_table():
    """A sample displaced past the table's edge gets no bias at all."""
    pos = torch.tensor([[[-1.0, -1.0], [5.0, 5.0]]])  # (1, 2, 2)
    table = torch.ones(1, 1, 5, 5)
    bias = rpe_bias(pos, table, 2, 2)
    assert bias.shape == (1, 1, 4, 2)
    assert torch.all(bias[..., 1] == 0)
    assert torch.all(bias[..., 0] > 0)

