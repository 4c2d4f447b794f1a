"""The benchmark of rpg_svo_tpu_torch (see README.md)."""
