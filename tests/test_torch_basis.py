"""The learned bases (a 3D texture and an MLP of the view direction) of the
port against the JAX package's ``core.sh``, in float64 on the CPU: each
function of ``core.sh``, the texture's TV (K12g's plain version),
checkpoints written by either package, and the gradients of every surface
renderer and of the packed cuvol renderer with respect to the texture and
to every MLP tensor (K5b's and K8's ``sh_mult`` cotangent on the card,
autograd here)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphasurf_tpu as at
import alphasurf_torch as pt
from alphasurf_tpu import defs
from alphasurf_tpu.core import sh as JSH
from alphasurf_tpu.losses import reg as JR
from alphasurf_tpu.render import cuvol as JC
from alphasurf_tpu.render import surface as JS
from alphasurf_tpu.utils import io as JIO
from alphasurf_torch.core import sh as TSH
from alphasurf_torch.core.grid import SparseGrid
from alphasurf_torch.losses import reg as TR
from alphasurf_torch.render import cuvol as TC
from alphasurf_torch.render import surface as TS
from alphasurf_torch.utils import io as TIO
from test_torch_util import BASE, jax_grid, np_grid, np_rays, t64

BD = 4  # basis_dim of the test grids
HIDDEN = 16  # the test MLP's hidden width (JAX's default is 64)
DEAD = 3  # the hidden unit whose bias keeps it off on every direction
MLP_KEYS = ("w0", "b0", "w1", "b1")


def np_texture(R=8, seed=7):
    """JAX's "sh" init of an (R, R, R, BD) texture plus seeded noise, so that
    no two channels of a cell move together."""
    tex = np.asarray(JSH.reinit_learned_bases(R, BD, "sh"), np.float64)
    return tex + np.random.default_rng(seed).standard_normal(tex.shape) * 0.05


def np_mlp(seed=8, hidden=HIDDEN):
    """MLP parameters at JAX's He scales from a numpy seed, small random
    biases, and hidden unit DEAD switched off by a large negative bias."""
    rng = np.random.default_rng(seed)
    in_dim = 3 * (2 * JSH.MLP_POSENC_DEG + 1)
    p = {"w0": rng.standard_normal((in_dim, hidden)) * (2.0 / in_dim) ** 0.5,
         "b0": rng.standard_normal(hidden) * 0.1,
         "w1": rng.standard_normal((hidden, BD)) * (2.0 / hidden) ** 0.5,
         "b1": rng.standard_normal(BD) * 0.1}
    p["b0"][DEAD] = -50.0
    return p


def basis_arrays(a: dict, basis: str) -> dict:
    """Grid arrays ``a`` with a learned basis: "texture" or "mlp"."""
    a = dict(a)
    if basis == "texture":
        a["basis_type"], a["basis_data"] = defs.BASIS_TYPE_3D_TEXTURE, np_texture()
    else:
        a["basis_type"], a["basis_mlp"] = defs.BASIS_TYPE_MLP, np_mlp()
    return a


def jax_basis_grid(a: dict, dtype=jnp.float64):
    """The JAX grid of ``basis_arrays``' output."""
    g = jax_grid(a, dtype).replace(basis_type=a.get("basis_type", defs.BASIS_TYPE_SH))
    if a.get("basis_data") is not None:
        g = g.replace(basis_data=jnp.asarray(a["basis_data"], dtype))
    if a.get("basis_mlp") is not None:
        g = g.replace(basis_mlp={k: jnp.asarray(v, dtype) for k, v in a["basis_mlp"].items()})
    return g


def basis_params(g: SparseGrid) -> dict:
    """The port grid's learned-basis tensors by name ("basis_data" or
    "basis_mlp.w0" ...)."""
    if g.basis_data is not None:
        return {"basis_data": g.basis_data}
    return {f"basis_mlp.{k}": v for k, v in g.basis_mlp.tensors().items()}


def test_posenc_and_mlp_match_jax():
    """posenc at each degree (the layout x, then sin and cos per octave), the
    MLP at the carried-over parameters (a dead unit among them) and its
    gradient with respect to every tensor, float64."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((50, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for deg in (0, 1, 4):
        np.testing.assert_allclose(TSH.posenc(t64(d), deg).numpy(),
                                   np.asarray(JSH.posenc(jnp.asarray(d), deg)), rtol=1e-14,
                                   atol=1e-15)
    np.testing.assert_allclose(TSH.posenc(t64(d), 2, include_identity=False).numpy(),
                               np.asarray(JSH.posenc(jnp.asarray(d), 2, False)), rtol=1e-14,
                               atol=1e-15)
    p = np_mlp()
    w = rng.standard_normal((50, BD))
    ref, ref_g = jax.value_and_grad(
        lambda q: jnp.sum(JSH.eval_basis_mlp(q, jnp.asarray(d)) * w))(
        {k: jnp.asarray(v) for k, v in p.items()})
    mlp = TSH.BasisMLP.from_dict(p, dtype=torch.float64)
    assert [n for n, _ in mlp.named_parameters()] == list(MLP_KEYS)
    ts = [t.requires_grad_(True) for t in mlp.tensors().values()]
    out = torch.sum(TSH.eval_basis_mlp(mlp, t64(d)) * t64(w))
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-12)
    for k, g in zip(MLP_KEYS, torch.autograd.grad(out, ts)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_g[k]), rtol=1e-12, atol=1e-14,
                                   err_msg=k)
    # the dead unit takes no gradient, its weights none either
    gb0 = torch.autograd.grad(torch.sum(TSH.eval_basis_mlp(mlp, t64(d)) * t64(w)), ts[1])[0]
    assert float(gb0[DEAD]) == 0.0 and float(torch.abs(gb0).max()) > 0
    # the port's own init: JAX's shapes, zero biases, He scales
    m = TSH.init_basis_mlp(torch.Generator().manual_seed(0), 9)
    assert tuple(m.w0.shape) == (27, 64) and tuple(m.w1.shape) == (64, 9)
    assert float(m.b0.abs().max()) == 0 and float(m.b1.abs().max()) == 0
    assert abs(float(m.w0.std()) / (2.0 / 27) ** 0.5 - 1) < 0.1


def test_texture_and_dispatch_match_jax():
    """The texture lookup at random directions and on the cube's faces and
    edges (the upper face at fraction 1), and the dispatch: a texture grid,
    an MLP grid, an SH grid and a texture grid without its texture (which
    evaluates SH, as JAX's)."""
    rng = np.random.default_rng(1)
    d = rng.standard_normal((60, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.concatenate([d, np.eye(3), -np.eye(3), [[1.0, 1.0, 0.0]], [[0.0, -1.0, 1.0]]])
    tex = np_texture()
    np.testing.assert_allclose(TSH.eval_learned_basis(t64(tex), t64(d)).numpy(),
                               np.asarray(JSH.eval_learned_basis(jnp.asarray(tex),
                                                                 jnp.asarray(d))),
                               rtol=1e-13, atol=1e-14)
    a = np_grid(6, seed=2, basis_dim=BD)
    for case in ("texture", "mlp", "sh", "texture_without_data"):
        b = basis_arrays(a, "mlp" if case == "mlp" else "texture")
        if case == "sh":
            b = dict(a)
        elif case == "texture_without_data":
            b["basis_data"] = None
        ref = JSH.eval_basis(jax_basis_grid(b), jnp.asarray(d))
        got = TSH.eval_basis(SparseGrid.from_numpy(b, device="cpu"), t64(d))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14,
                                   err_msg=case)
    # create_grid takes a basis as JAX's grid.replace gives one after it
    from alphasurf_torch.core.grid import create_grid

    g = create_grid(6, basis_dim=BD, basis_type=defs.BASIS_TYPE_3D_TEXTURE,
                    basis_data=torch.as_tensor(tex), dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(TSH.eval_basis(g, t64(d)).numpy(),
                                  TSH.eval_learned_basis(t64(tex), t64(d)).numpy())


@pytest.mark.parametrize("init", ["sh", "sg", "fourier"])
def test_reinit_learned_bases_matches_jax(init):
    """The three inits, float32 as JAX's; the upper hemisphere folded for
    "sh"; sg at a lambda range other than the default."""
    kw = dict(sh=dict(upper_hemi=True), sg=dict(sg_lambda_max=3.0, seed=4),
              fourier=dict(seed=5))[init]
    ref = np.asarray(JSH.reinit_learned_bases(8, 9, init, **kw))
    got = TSH.reinit_learned_bases(8, 9, init, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 8, 8, 9)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown basis init"):
        TSH.reinit_learned_bases(4, 4, "wavelet")


def test_basis_tv_matches_jax():
    """K12g's plain version: loss and gradient against jax.value_and_grad,
    float64; 0 without a texture."""
    tex = np_texture(R=6)
    a = np_grid(6, seed=2, basis_dim=BD)
    gj = jax_basis_grid(dict(a, basis_type=defs.BASIS_TYPE_3D_TEXTURE, basis_data=tex))
    ref, ref_g = jax.value_and_grad(
        lambda b: JR.basis_tv_loss(gj.replace(basis_data=b)))(gj.basis_data)
    b = t64(tex).requires_grad_(True)
    g = SparseGrid.from_numpy(a, device="cpu")
    g.basis_data = torch.nn.Parameter(b)
    loss = TR.basis_tv_loss(g)
    (got_g,) = torch.autograd.grad(loss, [g.basis_data])
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-11, atol=1e-15)
    assert TR.basis_tv_loss(SparseGrid.from_numpy(a, device="cpu")) == 0.0


@pytest.mark.parametrize("basis", ["texture", "mlp"])
def test_checkpoints_cross_packages(tmp_path, basis):
    """JAX save -> port load -> port save -> JAX load, and the port's load
    of a checkpoint whose basis_data is empty (svox2's SH grids): the basis
    arrays, basis_type and the rows equal; the texture or the MLP keys
    written as JAX writes them."""
    a = basis_arrays(np_grid(6, seed=2, basis_dim=BD), basis)
    gj = jax_basis_grid(a, jnp.float32)
    JIO.save_grid(gj, str(tmp_path / "j.npz"), step_id=3)
    g, step = TIO.load_grid(str(tmp_path / "j.npz"), device="cpu")
    assert step == 3 and g.basis_type == a["basis_type"]
    TIO.save_grid(g, str(tmp_path / "t.npz"), step_id=4)
    assert sorted(np.load(tmp_path / "t.npz").files) == sorted(np.load(tmp_path / "j.npz").files)
    back, _ = JIO.load_grid(str(tmp_path / "t.npz"))
    own, _ = JIO.load_grid(str(tmp_path / "j.npz"))  # SH went through float16
    assert back.basis_type == a["basis_type"]
    for k in ("links", "density_data", "sh_data", "surface_data"):
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), np.asarray(getattr(own, k)),
                                      err_msg=k)
    if basis == "texture":
        np.testing.assert_array_equal(np.asarray(back.basis_data), np.asarray(gj.basis_data))
        assert back.basis_mlp is None and g.basis_mlp is None
    else:
        for k in MLP_KEYS:
            np.testing.assert_array_equal(np.asarray(back.basis_mlp[k]),
                                          np.asarray(gj.basis_mlp[k]), err_msg=k)
        assert back.basis_data is None and g.basis_data is None
    z = dict(np.load(tmp_path / "j.npz"))
    z["basis_data"] = np.zeros((0,), np.float32)
    z.pop("basis_mlp.w0", None)
    np.savez(tmp_path / "empty.npz", **{k: v for k, v in z.items()
                                        if not k.startswith("basis_mlp.")})
    g0, _ = TIO.load_grid(str(tmp_path / "empty.npz"), device="cpu")
    assert g0.basis_data is None and g0.basis_mlp is None
    # the grid's replace keeps the basis (topology and the Trainer rebuild grids)
    r = g.replace(density_data=g.density_data * 2)
    for k, v in basis_params(g).items():
        np.testing.assert_array_equal(basis_params(r)[k].numpy(), v.detach().numpy(), err_msg=k)


OPT = dict(BASE, background_brightness=0.7, step_size=0.5)
RENDERERS = ("packed", "compact", "dense", "cuvol_packed")


def _jax_render(name, gj, o, d, opt):
    rays = at.Rays(o, d)
    if name == "packed":
        return JS.volume_render_surface_packed(gj, rays, opt, entries_per_ray=64.0)
    if name == "compact":
        return JS.volume_render_surface_compact(gj, rays, opt, max_intersect_voxels=64)
    if name == "dense":
        return JS.volume_render_surface(gj, rays, opt)
    return JC.volume_render_cuvol_packed(gj, rays, opt, entries_per_ray=64.0)


def _port_render(name, g, o, d, opt):
    rays = pt.Rays(t64(o), t64(d))
    if name == "packed":
        return TS.volume_render_surface_packed(g, rays, opt)
    if name == "compact":
        return TS.volume_render_surface_compact(g, rays, opt, max_intersect_voxels=64)
    if name == "dense":
        return TS.volume_render_surface(g, rays, opt)
    return TC.volume_render_cuvol_packed(g, rays, opt)


@functools.lru_cache(maxsize=None)
def _render_grid():
    return np_grid(10, seed=3, prune=0.1, basis_dim=BD)


@pytest.mark.parametrize("basis", ["texture", "mlp"])
@pytest.mark.parametrize("name", RENDERERS)
def test_renderer_basis_gradients_match_jax(name, basis):
    """rgb and the gradient of a weighted sum of rgb with respect to the
    texture or every MLP tensor, and to the SH rows, against jax.grad,
    float64, rtol 1e-7 (the packed renderers through one jitted call, the
    others eagerly); the basis's gradient is not 0."""
    a = basis_arrays(_render_grid(), basis)
    gj = jax_basis_grid(a)
    o, d = np_rays(32, seed=6)
    w = np.random.default_rng(12).standard_normal((o.shape[0], 3))
    opt_j, opt_t = at.RenderOptions(**OPT), pt.RenderOptions(**OPT)
    field = "basis_data" if basis == "texture" else "basis_mlp"

    def loss(vals, o_, d_):
        out = _jax_render(name, gj.replace(**{field: vals[0], "sh_data": vals[1]}), o_, d_,
                          opt_j)
        return jnp.sum(out["rgb"] * w), out["rgb"]

    fn = jax.value_and_grad(loss, has_aux=True)
    if name != "dense":
        fn = jax.jit(fn)
    (_, rgb_j), (g_basis, g_sh) = fn((getattr(gj, field), gj.sh_data), jnp.asarray(o),
                                     jnp.asarray(d))
    ref = ({"basis_data": g_basis} if basis == "texture"
           else {f"basis_mlp.{k}": v for k, v in g_basis.items()})
    ref["sh_data"] = g_sh
    g = SparseGrid.from_numpy(a, device="cpu")
    params = {**basis_params(g), "sh_data": g.sh_data}
    for p in params.values():
        p.requires_grad_(True)
    out = _port_render(name, g, o, d, opt_t)
    np.testing.assert_allclose(out["rgb"].detach().numpy(), np.asarray(rgb_j), rtol=1e-10,
                               atol=1e-13)
    grads = torch.autograd.grad(torch.sum(out["rgb"] * t64(w)), list(params.values()))
    for (k, _), gt in zip(params.items(), grads):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(gt.numpy(), r, rtol=1e-7, atol=1e-10 * np.abs(r).max(),
                                   err_msg=k)
    first = next(iter(params))
    assert np.abs(np.asarray(ref[first])).max() > 0, first
