"""The port's calibration probes: P1-P3 as `python -m
mhc_tpu_torch.bench.loop_calib`, `.mosaic_probe` and `.vpu_probe`."""
