"""Offline dataset preparation (port of disn_tpu/preprocessing): the SDF
ground truth of each mesh (sdf_gen) and the image+camera h5 of each
rendered view (img_gen)."""
from disn_tpu_torch.preprocessing.img_gen import (  # noqa: F401
    generate_object_views, parse_render_metadata, view_record_from_meta,
)
from disn_tpu_torch.preprocessing.sdf_gen import (  # noqa: F401
    check_insideout, generate_object, normalize_mesh, stratified_sample_grid,
)
