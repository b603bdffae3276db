"""The single-card tools of the port (the counterparts of the repository's
tools/*.py), each a module with a main(argv) that prints JSON:

    python -m monorfs_tpu_torch.tools.profile_phd     per-stage times of the PHD step
    python -m monorfs_tpu_torch.tools.roofline_phd    stage times against the card's ceilings
    python -m monorfs_tpu_torch.tools.ablate          stages taken out of the step
    python -m monorfs_tpu_torch.tools.smoother_lab REC     per-sweep ATE + final OSPA
    python -m monorfs_tpu_torch.tools.debug_loopy REC      per-sweep ATE + objective
    python -m monorfs_tpu_torch.tools.isam2_lab REC -g CFG candidate promotions of a replay
    python -m monorfs_tpu_torch.tools.scanda_profile  the scan-da runner's costs

Each takes --device (cuda by default; without a GPU it raises unless given
--device cpu)."""
