"""The stage-2 visual-grouping tools (MAA, semantic constraints) and their counters.

``STATS`` counts the semantic constraint's device work since ``reset_stats()``,
from shapes on the host (no counter reads the device):

* ``frames``: frames through ``pipeline.DinoFeatures``;
* ``tokens``: their tokens (the patch grid and the CLS token);
* ``attention_pairs``: heads x tokens^2 of every block that runs attention,
  summed over blocks and frames (the ViT's last block gives its keys alone);
* ``ncut_steps``: the Adam steps of ``ncut.ncut_refine``.
"""

STATS = {"frames": 0, "tokens": 0, "attention_pairs": 0, "ncut_steps": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


from .ncut import ncut_refine, soft_ncut_value  # noqa: E402,F401
