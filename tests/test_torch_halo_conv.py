"""Kernels A and D at depth padding 0 (``pad_d=0``): the conv of a depth
shard that carries one neighbour plane on each side, as the spatial tier
runs it behind ``ops.halo.halo_exchange_d``.

On the CPU the wrappers take their plain versions; they are held against
the slab of the padded conv (the unsharded conv's output on the shard's
planes), against ``jax.lax.conv_general_dilated`` with depth padding 0 and
its ``jax.vjp``, and the input gradient of every shard, its halo planes
added back into the neighbours' boundary planes (the exchange's adjoint,
emulated here), against the unsharded conv's ``dx``.  The weight gradients
of the shards sum to the unsharded one, and repeat bit for bit.  The
stride-2 input gradient's parity-class index math at ``pad_d=0`` (the
tap table with the depth parities traded and the kernel's halo origin
``pd - 1``) is emulated in torch as ``csrc/conv3d_mma.cu`` reads its
operands.  ``pad_d=1`` stays what it was (the existing tests of
``test_torch_conv_mma.py`` and ``test_torch_grads.py`` hold it).

Tolerances (float32): 1e-5 of each tensor's largest entry, the summation
order of the shards' weight gradients against the whole volume's being the
only difference; the plain slabs and the repeated weight gradients are
held bit for bit.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepatlas_torch.kernels import (conv3d_k3, conv3d_k3_input_grad,
                                     conv3d_k3_input_grad_plain,
                                     conv3d_k3_plain, conv3d_k3_wgrad,
                                     conv3d_k3_wgrad_plain, pack_k3_weights,
                                     parity_tap_table)
from deepatlas_torch.kernels.conv3d import (adjoint_k3_weights,
                                            strided_shape)

TOL = 1e-5
# (B, D, H, W), Cin, Cout: depths that split into 2 or 4 shards, an odd
# side, one input channel (the registration pair is 2)
CASES = [((1, 8, 5, 6), 2, 4), ((2, 12, 4, 5), 3, 8), ((1, 16, 3, 7), 1, 3)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def operands(shape, cin, cout, seed=230):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout) / np.sqrt(
        27 * cin)).astype(np.float32))
    return x, w


def halo_slabs(x, n):
    """The shards of ``x`` split in depth over ``n`` ranks, each with its
    neighbours' boundary plane (zeros at the volume's ends): what the
    exchange hands each rank."""
    d = x.shape[1] // n
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    return [xp[:, i * d:(i + 1) * d + 2].contiguous() for i in range(n)]


def close(got, ref, tol=TOL):
    got = torch.as_tensor(np.array(got, dtype=np.float32))
    ref = torch.as_tensor(np.array(ref, dtype=np.float32))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = (got - ref).abs().max().item()
    assert err <= tol * max(ref.abs().max().item(), 1e-30), err


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_pad0_forward_is_the_padded_convs_slab(case, stride):
    shape, cin, cout = case
    x, w = operands(shape, cin, cout)
    full = conv3d_k3_plain(x, w, stride=stride)
    n = 2
    outs = [conv3d_k3_plain(s, w, stride=stride, pad_d=0)
            for s in halo_slabs(x, n)]
    d_out = full.shape[1] // n
    for i, y in enumerate(outs):
        assert y.shape[1] == d_out
        assert torch.equal(y, full[:, i * d_out:(i + 1) * d_out])
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(conv3d_k3(halo_slabs(x, n)[0], w, stride=stride,
                                 pad_d=0), outs[0])


@pytest.mark.parametrize("stride", [1, 2])
def test_pad0_forward_and_vjp_match_lax(stride):
    import jax
    import jax.numpy as jnp

    shape, cin, cout = (1, 10, 5, 6), 3, 4
    x, w = operands(shape, cin, cout, seed=7)
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    y = conv3d_k3(xr, wr, stride=stride, pad_d=0)
    g = torch.from_numpy(np.random.RandomState(1).randn(*y.shape).astype(
        np.float32))
    (y * g).sum().backward()

    def f(a, k):
        return jax.lax.conv_general_dilated(
            a, k, (stride,) * 3, [(0, 0), (1, 1), (1, 1)],
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))

    ref, vjp = jax.vjp(f, jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    dx_ref, dw_ref = vjp(jnp.asarray(g.numpy()))
    close(y.detach(), np.asarray(ref))
    close(xr.grad, np.asarray(dx_ref))
    close(wr.grad, np.asarray(dw_ref))
    # the input gradient's entry point
    close(conv3d_k3_input_grad(g, w, x.shape[1:4], stride, pad_d=0),
          np.asarray(dx_ref))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_halo_dx_summed_back_is_the_unsharded_dx(stride, n):
    """Each shard's ``dx`` covers its halo planes too; adding them into the
    neighbours' boundary planes (the exchange's adjoint) gives the
    unsharded conv's ``dx``, and the shards' ``dW`` sum to its ``dW``."""
    shape, cin, cout = (1, 16, 4, 5), 2, 3
    x, w = operands(shape, cin, cout, seed=11)
    g_full = torch.from_numpy(np.random.RandomState(2).randn(
        shape[0], *strided_shape(shape[1:], stride), cout).astype(
            np.float32))
    dx_full = conv3d_k3_input_grad_plain(g_full, w, shape[1:], stride)
    dw_full = conv3d_k3_wgrad_plain(x, g_full, stride)

    d = shape[1] // n
    d_out = g_full.shape[1] // n
    dx = torch.zeros(shape[0], shape[1] + 2, *shape[2:], cin)
    dw = torch.zeros_like(dw_full)
    for i, slab in enumerate(halo_slabs(x, n)):
        g = g_full[:, i * d_out:(i + 1) * d_out].contiguous()
        dx_i = conv3d_k3_input_grad(g, w, slab.shape[1:4], stride, pad_d=0)
        assert dx_i.shape[1] == d + 2
        dx[:, i * d:(i + 1) * d + 2] += dx_i     # halo planes go back
        dw += conv3d_k3_wgrad(slab, g, stride, pad_d=0)
    close(dx[:, 1:-1], dx_full)
    close(dw, dw_full)


@pytest.mark.parametrize("stride", [1, 2])
def test_pad0_wgrad_repeats_bit_for_bit(stride):
    x, w = operands((2, 10, 5, 4), 3, 5, seed=5)
    g = torch.from_numpy(np.random.RandomState(3).randn(
        2, *strided_shape((10, 5, 4), stride, 0), 5).astype(np.float32))
    runs = [conv3d_k3_wgrad(x, g, stride, pad_d=0) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    assert torch.equal(runs[0], conv3d_k3_wgrad_plain(x, g, stride, 0))


def test_pad0_shapes_and_errors():
    x, w = operands((1, 6, 4, 4), 2, 3)
    assert strided_shape((6, 4, 5), 1, 0) == (4, 4, 5)
    assert strided_shape((6, 4, 5), 2, 0) == (2, 2, 3)
    assert strided_shape((6, 4, 5), 2, 1) == (3, 2, 3)
    with pytest.raises(ValueError, match="pad_d"):
        conv3d_k3(x, w, pad_d=2)
    with pytest.raises(ValueError, match="no output plane"):
        conv3d_k3(x[:, :2].contiguous(), w, pad_d=0)
    with pytest.raises(ValueError, match="depth padding 0|pad_d 0"):
        conv3d_k3_input_grad(torch.zeros(1, 6, 4, 4, 3), w, (6, 4, 4), 1, 0)
    with pytest.raises(ValueError, match="share their voxels"):
        conv3d_k3_wgrad(x, torch.zeros(1, 6, 4, 4, 3), 1, 0)


def test_pad0_parity_tap_table():
    """At ``pad_d=0`` depth parity 0 meets taps kz 0 and 2 and parity 1
    meets kz 1 (``i = 2o + kz``); H and W keep the pad-1 parities."""
    table, table1 = parity_tap_table(0), parity_tap_table(1)
    assert sorted(t for taps in table for t in taps) == list(range(27))
    for cls, taps in enumerate(table):
        pz = cls >> 2
        for tap in taps:
            kz = tap // 9
            assert (kz in (0, 2)) if pz == 0 else kz == 1
        # the H, W parts are the pad-1 table's with the depth class traded
        hw = sorted(t % 9 for t in taps)
        assert hw == sorted(t % 9 for t in table1[cls ^ 4])


def parity_dx_pd(g, wk, dhw, pd):
    """The stride-2 ``dx`` by parity class at depth padding ``pd`` as the
    tensor-core kernel reads its operands: the grid covers ``ceil(n / 2)``
    class voxels per axis, the depth halo starts at grid plane ``pd - 1``
    and tap ``kz`` of class ``pz`` reads halo plane ``((pz + pd - kz) >> 1)
    - (pd - 1)``; H and W read ``(p + 1 - k) >> 1``; the weights are row
    ``26 - tap`` of the packed adjoint."""
    packed = pack_k3_weights(adjoint_k3_weights(wk)).float()
    b, cg, cx = g.shape[0], g.shape[-1], wk.shape[-2]
    cp = -(-cg // 8) * 8
    zorg = pd - 1
    gp = F.pad(g.float(), (0, cp - cg, 0, 1, 0, 1, -zorg, 2))
    dx = torch.zeros(b, *dhw, cx)
    for cls, taps in enumerate(parity_tap_table(pd)):
        p = (cls >> 2, (cls >> 1) & 1, cls & 1)
        n = [(dhw[a] - p[a] + 1) // 2 for a in range(3)]
        acc = torch.zeros(b, *n, packed.shape[1])
        for tap in taps:
            k = (tap // 9, tap // 3 % 3, tap % 3)
            o = [((p[0] + pd - k[0]) >> 1) - zorg,
                 (p[1] + 1 - k[1]) >> 1, (p[2] + 1 - k[2]) >> 1]
            rows = packed[(26 - tap) * cp:(27 - tap) * cp]
            acc += gp[:, o[0]:o[0] + n[0], o[1]:o[1] + n[1],
                      o[2]:o[2] + n[2]] @ rows
        dx[:, p[0]::2, p[1]::2, p[2]::2] = acc[..., :cx]
    return dx


@pytest.mark.parametrize("pd", [0, 1])
@pytest.mark.parametrize("dhw", [(10, 5, 6), (9, 4, 7), (8, 6, 5)])
def test_parity_class_dx_index_math(dhw, pd):
    cin, cout = 3, 5
    x, w = operands((1, *dhw), cin, cout, seed=13)
    w = w.bfloat16().float()    # the packed weights' values
    g = torch.from_numpy(np.random.RandomState(4).randn(
        1, *strided_shape(dhw, 2, pd), cout).astype(np.float32))
    ref = conv3d_k3_input_grad_plain(g, w, dhw, 2, pd)
    close(parity_dx_pd(g, w, dhw, pd), ref)
