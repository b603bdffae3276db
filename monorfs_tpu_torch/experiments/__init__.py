"""The thesis' experiment grids on the port (the counterparts of the
repository's experiments/*.py), reading the cfg files of experiments/configs
in place:

    python -m monorfs_tpu_torch.experiments.run_experiments chap3-s1 [--outdir DIR] [--device cpu]
    python -m monorfs_tpu_torch.experiments.run_gpu_grid chap3-s1|...|throughput|all
    python -m monorfs_tpu_torch.experiments.summarize [DIR]"""
