"""Closed-loop tools (ports of the JAX package's scripts/): each runs as
``python -m disn_tpu_torch.tools.<name>``, on the card unless
``--device cpu`` is passed.

- ``closed_loop``: the production image -> mesh path at 257^3 scored
  against the analytic ground truth through the reference's metric
  protocol, with the given camera and with the camera net's estimate;
- ``train_convergence``: the full-width bf16 net trained on the synthetic
  records, then one training view reconstructed and scored;
- ``eval_rehearsal``: the evaluation protocol timed on production-size
  meshes and extrapolated to a full split.
"""
