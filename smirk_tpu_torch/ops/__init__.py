"""smirk_tpu_torch.ops: the kernel-level op namespace.

The same import surface as the JAX package's `smirk_tpu.ops`: the
rasterizers (with their CUDA kernels), mesh geometry, masking and sampling
ops, FLAME math and shading, from the port's own modules.
"""
from smirk_tpu_torch.flame.lbs import (  # noqa: F401
    batch_rigid_transform,
    batch_rodrigues,
    blend_shapes,
    lbs,
    vertices2joints,
    vertices2landmarks,
)
from smirk_tpu_torch.masking.masking import (  # noqa: F401
    compose_mask,
    sample_mesh_points,
    transfer_pixels,
    triangle_area_xy,
)
from smirk_tpu_torch.render.camera import batch_orth_proj, orth_proj_ndc  # noqa: F401
from smirk_tpu_torch.render.geometry import (  # noqa: F401
    build_vertex_face_incidence,
    face_vertices,
    vertex_normals,
    vertex_normals_gather,
)
from smirk_tpu_torch.render.rasterizer import (  # noqa: F401
    bin_faces,
    face_records,
    face_records_shaded,
    interpolate_attributes,
    rasterize,
    rasterize_coverage,
    rasterize_coverage_jnp,
    rasterize_coverage_pallas,
    rasterize_coverage_pallas_v3,
    rasterize_normals_fused,
)
from smirk_tpu_torch.render.shading import (  # noqa: F401
    directional_shading,
    point_shading,
    sh_shading,
)
