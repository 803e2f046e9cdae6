"""B10, the fused SepConvGRU pass, in the port against the JAX package on
the CPU: the plain forward against ``gru_pass`` in interpret mode (fp32 and
bf16, horizontal and vertical), the backward of ``GruPass`` (its plain path)
against ``jax.grad`` of ``gru_pass`` in interpret mode (all 11 gradients),
a float64 gradcheck, and the module option ``SepConvGRU(fused=...)``:
'on' against the JAX module's 'on' (forward and gradients, weights carried
by ``state_dict_from_flax``), 'on' against the port's own 'off', and the
conv form under ``static`` or 'auto' on a CPU tensor.  The sizes are
``tests/test_sep_conv_gru.py``'s: odd widths, and row counts that no tile
of the Pallas kernel divides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.nn.update import SepConvGRU as JaxSepConvGRU
from craft_tpu.ops.pallas.sep_conv_gru import gru_pass as jax_gru_pass
from craft_tpu_torch.nn import update as tupdate
from craft_tpu_torch.nn.update import SepConvGRU
from craft_tpu_torch.ops.kernels import sep_conv_gru as sg
from craft_tpu_torch.ops.kernels.launch import launch_counts
from craft_tpu_torch.utils.weights import state_dict_from_flax

GRAD_NAMES = ["h", "x", "wzh", "wzx", "wrh", "wrx", "wqh", "wqx", "bz",
              "br", "bq"]


def _mk(seed, B, H, W, Ch, Cx):
    """h, x [B, HW, C] and the 11 pass arguments (taps split at Ch), as
    numpy fp32, in tests/test_sep_conv_gru.py's scales."""
    rng = np.random.RandomState(seed)
    h = rng.randn(B, H * W, Ch).astype(np.float32) * 0.5
    x = rng.randn(B, H * W, Cx).astype(np.float32) * 0.5
    ws = []
    for _ in range(3):
        w = (rng.randn(5, Ch + Cx, Ch) * 0.05).astype(np.float32)
        ws += [w[:, :Ch], w[:, Ch:]]
    bs = [(rng.randn(Ch) * 0.1).astype(np.float32) for _ in range(3)]
    return [h, x, *ws, *bs], rng


def _jax(args, stride, W, h_dtype=jnp.float32):
    ja = [jnp.asarray(a) for a in args]
    ja[0] = ja[0].astype(h_dtype)
    return jax_gru_pass(*ja, stride, W, True)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_plain_forward_matches_pallas_interpret(horizontal):
    B, H, W, Ch, Cx = 2, 6, 11, 16, 24
    args, _ = _mk(0, B, H, W, Ch, Cx)
    stride = 1 if horizontal else W
    want = np.asarray(_jax(args, stride, W))
    got = sg.gru_pass_fwd_plain(*map(torch.from_numpy, args), stride, W)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_plain_forward_bf16_within_one_ulp(horizontal):
    """bf16 h: both round the same fp32 values to bf16 (x and the weights
    cast to bf16, r h rounded, sums in fp32), so they differ by at most one
    bf16 ulp where a sum in another order crosses a rounding boundary."""
    B, H, W, Ch, Cx = 2, 6, 11, 16, 24
    args, _ = _mk(1, B, H, W, Ch, Cx)
    stride = 1 if horizontal else W
    want = np.asarray(_jax(args, stride, W, jnp.bfloat16).astype(
        jnp.float32))
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = targs[0].bfloat16()
    got = sg.gru_pass_fwd_plain(*targs, stride, W)[0]
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= _bf16_ulp(want)).all(), float(diff.max())


@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_plain_backward_matches_jax_grad(horizontal):
    B, H, W, Ch, Cx = 2, 5, 9, 8, 16
    args, rng = _mk(2, B, H, W, Ch, Cx)
    gw = rng.randn(B, H * W, Ch).astype(np.float32)
    stride = 1 if horizontal else W

    def loss(*a):
        return jnp.sum(jax_gru_pass(*a, stride, W, True) * gw)
    want = jax.grad(loss, argnums=tuple(range(11)))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = sg.gru_pass(*targs, stride, W)
    (out * torch.from_numpy(gw)).sum().backward()
    for name, t, w in zip(GRAD_NAMES, targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("stride", [1, 4], ids=["h", "v"])
def test_gru_pass_gradcheck_float64(stride):
    B, H, W, Ch, Cx = 1, 3, 4, 3, 2
    args, _ = _mk(3, B, H, W, Ch, Cx)
    targs = [torch.from_numpy(a).double().requires_grad_() for a in args]
    assert torch.autograd.gradcheck(
        lambda *a: sg.gru_pass(*a, stride, W), targs, eps=1e-6, atol=1e-6)


def test_plain_backward_takes_g_in_the_io_type():
    """The cotangent is rounded to h's type first, as the JAX VJP does."""
    args, rng = _mk(4, 1, 3, 5, 8, 8)
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = targs[0].bfloat16()
    _, z, r, q = sg.gru_pass_fwd_plain(*targs, 1, 5)
    g = torch.from_numpy(rng.randn(1, 15, 8).astype(np.float32))
    res = (targs[0], targs[1], z, r, q)
    a = sg.gru_pass_bwd_plain(*res, g, *targs[2:8], 1, 5)
    b = sg.gru_pass_bwd_plain(*res, g.bfloat16(), *targs[2:8], 1, 5)
    assert a[0].dtype == torch.bfloat16 and a[1].dtype == torch.float32
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _modules(seed, B, H, W, Ch, Cx):
    """Seeded h, x [B, H, W, C], the JAX SepConvGRU's initial variables and
    a port SepConvGRU(fused='on') carrying them."""
    rng = np.random.RandomState(seed)
    h = rng.randn(B, H, W, Ch).astype(np.float32) * 0.5
    x = rng.randn(B, H, W, Cx).astype(np.float32) * 0.5
    variables = JaxSepConvGRU(hidden_dim=Ch).init(
        jax.random.PRNGKey(3), jnp.asarray(h), jnp.asarray(x))
    sd = state_dict_from_flax({"params": {"gru": variables["params"]}})
    mod = SepConvGRU(Ch, Cx, fused="on")
    mod.load_state_dict({k[len("gru."):]: v for k, v in sd.items()},
                        strict=True)
    return variables, mod, h, x


def test_module_fused_matches_the_jax_fused_module():
    B, H, W, Ch, Cx = 2, 7, 10, 16, 24
    variables, mod, h, x = _modules(5, B, H, W, Ch, Cx)
    jmod = JaxSepConvGRU(hidden_dim=Ch, fused="on")

    def loss(v, h_, x_):
        return jnp.sum(jmod.apply(v, h_, x_) ** 2)
    want = jmod.apply(variables, jnp.asarray(h), jnp.asarray(x))
    gv, gh, gx = jax.grad(loss, argnums=(0, 1, 2))(
        variables, jnp.asarray(h), jnp.asarray(x))
    th = torch.from_numpy(h).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    got = mod(th, tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=3e-5, rtol=1e-4)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=3e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=3e-4,
                               rtol=1e-3)
    gsd = state_dict_from_flax({"params": {"gru": gv["params"]}})
    params = dict(mod.named_parameters())
    assert len(params) == 12
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   gsd["gru." + name].numpy(), atol=3e-4,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_module_on_matches_off(dtype):
    """The port's fused pass against its own conv form, forward and every
    gradient; bf16 within the rounding of the conv form's bf16 gates."""
    B, H, W, Ch, Cx = 2, 5, 9, 16, 24
    _, on, h, x = _modules(6, B, H, W, Ch, Cx)
    off = SepConvGRU(Ch, Cx, fused="off")
    off.load_state_dict(on.state_dict())
    outs = []
    for mod in (on, off):
        mod.dtype = dtype
        th = torch.from_numpy(h).to(dtype).requires_grad_()
        tx = torch.from_numpy(x).requires_grad_()
        y = mod(th, tx)
        (y.float() ** 2).sum().backward()
        outs.append((y.detach().float(), th.grad.float(), tx.grad,
                     {n: p.grad.clone() for n, p in mod.named_parameters()}))
        mod.zero_grad()
    tol = {torch.float32: 1e-5, torch.bfloat16: 3e-2}[dtype]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert float((a - b).abs().max() / b.abs().max()) < tol
    for n, g in outs[0][3].items():
        want = outs[1][3][n]
        assert float((g - want).abs().max() / want.abs().max()) < tol, n


def test_static_and_auto_on_the_cpu_run_the_conv_form(monkeypatch):
    """`static` given (even with fused='on') and 'auto' on a CPU tensor
    take the conv form: no B10 pass runs and no kernel launches."""
    calls = []
    real = tupdate.gru_pass
    monkeypatch.setattr(tupdate, "gru_pass",
                        lambda *a: calls.append(a[-2]) or real(*a))
    B, H, W, Ch = 1, 4, 6, 128
    rng = np.random.RandomState(7)
    h = torch.from_numpy(np.tanh(rng.randn(B, H, W, Ch)).astype(np.float32))
    x = torch.from_numpy(rng.randn(B, H, W, 384).astype(np.float32))
    on = SepConvGRU(Ch, 384, fused="on")
    off = SepConvGRU(Ch, 384, fused="off")
    off.load_state_dict(on.state_dict())
    auto = SepConvGRU(Ch, 384, fused="auto")
    auto.load_state_dict(on.state_dict())
    before = launch_counts()
    static = on.static_contrib(x[..., :128])
    got = on(h, x[..., 128:], static=static)
    want = off(h, x[..., 128:], static=off.static_contrib(x[..., :128]))
    assert torch.equal(got, want)
    assert torch.equal(auto(h, x), off(h, x))
    assert calls == []
    on(h, x)
    assert calls == [1, W]  # the horizontal pass, then the vertical one
    assert launch_counts() == before
    assert before["gru_pass_fwd"] == before["gru_pass_bwd"] == 0


def test_fused_takes_only_its_three_settings():
    with pytest.raises(ValueError, match="fused"):
        SepConvGRU(8, 8, fused="yes")


def test_the_port_gate_is_the_jax_gate():
    from craft_tpu.ops.pallas.sep_conv_gru import fused_gru_vmem_ok
    for args in [(7040, 128, 384, 1, 2), (7040, 128, 384, 1, 4),
                 (100, 12, 24, 1, 2), (100, 256, 768, 1, 2),
                 (100, 16, 24, 1, 4)]:
        assert sg.fused_gru_vmem_ok(*args) == fused_gru_vmem_ok(*args), args
