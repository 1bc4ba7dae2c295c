"""`normal_planes`, the affine normal planes that K1's records carry: the
port writes each plane about corner 0, PC = n0 - PA*x0 - PB*y0, where the
JAX package's `attr_planes` sums each corner's edge function over the
face's doubled area, whose constants x_j*y_k - y_j*x_k cancel. The two are
the same plane; at a sliver face the cancelling form's rounding, divided by
the tiny area, moved the shaded inference render by up to 1e-3 under a
one-ulp change of the vertices, past the 1e-4 that batch 1 is held to
against a batched call (chip_smoke's [5o], where the batch changes cuDNN's
algorithms and so the vertices' last bits). Full width: the procedural
head's 224-px face region, on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.render import rasterizer as JR
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as R
from smirk_tpu_torch.render.renderer import Renderer
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

S = 224
B1_ATOL = 1e-4  # chip_smoke's [5o] rule on the render where pix_to_face agrees


@pytest.fixture(scope="module")
def scene():
    """The full-size head, recentred as chip_smoke's main path does,
    jittered, at two cams around scale 7 -> (renderer, verts, cam, face
    verts, face normals)."""
    bundle = procedural_bundle(seed=0, full_size=True)
    vt = np.array(bundle["v_template"], np.float32)
    vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
    bundle["v_template"] = vt
    rng = np.random.default_rng(0)
    verts = torch.from_numpy((vt[None] + rng.normal(0, 3e-4, (2,) + vt.shape))
                             .astype(np.float32))
    cam = torch.tensor([[7.0, 0.01, -0.02], [6.5, -0.03, 0.02]])
    r = Renderer(bundle, image_size=S, device="cpu")
    fv, fn = r._face_geometry(verts, r.project(verts, cam))
    return r, verts, cam, fv, fn


def test_planes_closer_to_exact_than_the_cancelling_form(scene):
    """At each face's centroid the plane's value is the mean of its
    corners' normals. Evaluated in float64 from the fp32 coefficients, the
    port's planes (`face_records_shaded`'s lanes 16-24) are within 1e-3 of
    it on every face (slivers down to 1e-3 px^2 included), and their worst
    error is under a tenth of the JAX package's form on the same faces."""
    _, _, _, fv, fn = scene
    f = fv.numpy().astype(np.float64)
    d = f[..., 1:, :2] - f[..., :1, :2]
    den = d[..., 0, 0] * d[..., 1, 1] - d[..., 0, 1] * d[..., 1, 0]
    real = np.abs(den) >= 1e-9  # well clear of AREA_EPS in both forms
    xc, yc = f[..., 0].mean(-1)[..., None], f[..., 1].mean(-1)[..., None]
    exact = fn.numpy().astype(np.float64).mean(-2)

    def err(planes):
        p = np.asarray(planes, np.float64)
        return np.abs(p[..., 0:3] * xc + p[..., 3:6] * yc + p[..., 6:9] - exact)[real]

    port = err(R.face_records_shaded(fv, fn)[..., 16:25].numpy())
    ref = err(JR.attr_planes(jnp.asarray(fv.numpy()), jnp.asarray(fn.numpy())))
    assert real.sum() > 6000 and (np.abs(den[real]) * S * S / 8).min() < 1e-3
    assert port.max() <= 1e-3, port.max()
    assert port.max() <= 0.1 * ref.max(), (port.max(), ref.max())


def test_inference_render_holds_under_one_ulp_vertex_changes(scene):
    """The inference render (K1's plain version here) of vertices moved by
    one ulp each, up, down or not at random, agrees with the render of the
    original vertices within B1_ATOL wherever pix_to_face agrees, over four
    draws, and pix_to_face agrees on >= 99.5 % of the pixels."""
    r, verts, cam, _, _ = scene
    rng = np.random.default_rng(1)

    def render(v):
        with torch.inference_mode():
            o = r(v, cam, inference=True)
        return o["rendered_img"].numpy(), o["pix_to_face"].numpy()

    base, p2f = render(verts)
    assert (p2f >= 0).mean() > 0.1
    for _ in range(4):
        step = torch.from_numpy(rng.integers(-1, 2, verts.shape).astype(np.float32))
        img, p = render(torch.nextafter(verts, verts + step))
        agree = p == p2f
        diff = np.where(agree[..., None], np.abs(img - base), 0).max()
        assert agree.mean() >= 0.995 and diff <= B1_ATOL, (agree.mean(), diff)
