"""K1, the fused cell decode: disn_tpu_torch's decode_cells (on the CPU it
runs the kernel's plain PyTorch twin) against disn_tpu's decode_cells (the
Pallas kernel in interpret mode, its escapes rescued through the XLA path)
and against the per-point XLA decode dense._decode_block(folded='137').

Both packages get the same params and the same folded map, so the
comparison isolates the decode. Cameras: the test_fused.py camera, whose
w=0 plane cuts the box (points behind it project and clamp; the TPU kernel
escapes there), and the demo camera."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.infer import dense as jdense
from disn_tpu.infer import fused as jfused
from disn_tpu.models import disn as jdisn
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config
from disn_tpu_torch.infer import dense, fused
from disn_tpu_torch.ops import fused_decode
from torch_threads import few_threads  # noqa: F401  (autouse)

TRANS = np.vstack([np.eye(3) * 60, [68.0, 68.0, 2.0]]).astype(np.float32)
GEOM = np.array([-1, -1, -1, 1, 1, 1], np.float32)
FINE_R = 49
COARSE_C = 12
CAMERAS = {"w0_plane_in_box": TRANS, "demo": jsynthetic.demo_trans_mat()}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    kw = dict(num_classes=32, width_mult=0.125, sdf_res=FINE_R - 1,
              compute_dtype=dtype)
    jcfg = JConfig(**kw)
    jparams = jdisn.init(jcfg, jax.random.PRNGKey(0))
    img = np.random.RandomState(1).rand(1, 137, 137, 3).astype(np.float32)
    _, jeps = jax.jit(functools.partial(jdense._prep, cfg=jcfg,
                                        fold_local="137"))(
        jparams, jnp.asarray(img))
    params = convert.params_from_jax(jax.device_get(jparams))
    eps = {k: torch.from_numpy(np.array(v.astype(jnp.float32))
                               ).to(DTYPES[dtype]) for k, v in jeps.items()}
    return jcfg, jparams, jeps, Config(**kw), params, eps


def _cells():
    return np.sort(np.random.RandomState(0).choice(
        COARSE_C ** 3, 96, replace=False)).astype(np.int32)


def _port(dtype, cam, cells):
    _, _, _, cfg, params, eps = _setup(dtype)
    return fused.decode_cells(params, eps, torch.from_numpy(cam),
                              torch.from_numpy(GEOM), torch.from_numpy(cells),
                              cfg, fine_r=FINE_R, coarse_c=COARSE_C).numpy()


def _oracle(dtype, cam, cells):
    jcfg, jparams, jeps, _, _, _ = _setup(dtype)
    pts, _ = jfused._cell_points(jnp.asarray(cells), COARSE_C, FINE_R,
                                jnp.asarray(GEOM))
    return np.asarray(jdense._decode_block(jparams, jeps, None,
                                           jnp.asarray(cam), pts, jcfg,
                                           folded="137"), np.float32)


def _assert_close(got, want, dtype):
    assert np.isfinite(got).all()
    if dtype == "float32":
        # summation order differs (XLA vs torch CPU): 1e-5 relative
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        # the bounds of tests/test_fused.py: both sides round to bf16 at
        # different places
        scale = max(1e-3, np.abs(want).max())
        assert np.abs(got - want).max() <= 0.02 * scale
        assert np.abs(got - want).mean() <= 0.003 * scale


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_decode_cells_matches_jax_kernel(dtype, cam):
    jcfg, jparams, jeps, _, _, _ = _setup(dtype)
    cells = _cells()
    want, esc_over = jfused.decode_cells(
        jparams, jeps, jnp.asarray(CAMERAS[cam]), jnp.asarray(GEOM),
        jnp.asarray(cells), jcfg, fine_r=FINE_R, coarse_c=COARSE_C)
    assert int(esc_over) == 0
    _assert_close(_port(dtype, CAMERAS[cam], cells), np.asarray(want), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_decode_cells_matches_xla_decode(dtype, cam):
    cells = _cells()
    _assert_close(_port(dtype, CAMERAS[cam], cells),
                  _oracle(dtype, CAMERAS[cam], cells), dtype)


def test_decode_block_matches_jax():
    """The port's per-point decode (boundary planes) against the JAX one."""
    cells = _cells()
    _, _, _, cfg, params, eps = _setup("float32")
    pts, _ = fused._cell_points(torch.from_numpy(cells), COARSE_C, FINE_R,
                                torch.from_numpy(GEOM))
    got = dense._decode_block(params, eps, None, torch.from_numpy(TRANS),
                              pts, cfg).numpy()
    _assert_close(got, _oracle("float32", TRANS, cells), "float32")


def test_cell_points_match_jax():
    cells = _cells()
    jp, jf = jfused._cell_points(jnp.asarray(cells), COARSE_C, FINE_R,
                                 jnp.asarray(GEOM))
    p, f = fused._cell_points(torch.from_numpy(cells), COARSE_C, FINE_R,
                              torch.from_numpy(GEOM))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


def _kernel_inputs(dtype):
    _, _, _, cfg, params, eps = _setup(dtype)
    cd = DTYPES[dtype]
    w = fused_decode.pack_weights(params, eps["g_contrib"], cd)
    return (eps["fold137"][0].contiguous(), w, torch.from_numpy(TRANS),
            torch.from_numpy(GEOM), torch.from_numpy(_cells()))


@pytest.mark.parametrize("bad", ["dtype", "shape", "cells", "grid", "bias"])
def test_wrapper_rejects_bad_inputs(bad):
    fmap, w, trans, geom, cells = _kernel_inputs("float32")
    kw = dict(fine_r=FINE_R, coarse_c=COARSE_C)
    if bad == "dtype":
        fmap = fmap.double()
    elif bad == "shape":
        fmap = fmap[:, :100].contiguous()
    elif bad == "cells":
        cells = cells.long()
    elif bad == "grid":
        kw["coarse_c"] = COARSE_C + 1
    else:
        w = w[:3] + (w[3].double(),) + w[4:]
    with pytest.raises((TypeError, ValueError)):
        fused_decode.fused_cell_decode(fmap, w, trans, geom, cells, **kw)


def test_plain_path_does_not_count_launches():
    fmap, w, trans, geom, cells = _kernel_inputs("float32")
    before = fused_decode.fused_cell_decode.launches
    out = fused_decode.fused_cell_decode(fmap, w, trans, geom, cells,
                                         fine_r=FINE_R, coarse_c=COARSE_C)
    assert out.shape == (cells.shape[0] * 64, 1)
    assert fused_decode.fused_cell_decode.launches == before
