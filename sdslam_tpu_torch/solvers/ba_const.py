"""Bundle-adjustment robust-kernel constants (same values as
sdslam_tpu/solvers/ba_const.py): Huber deltas sqrt(5.991) / sqrt(7.815),
the 95% chi2 quantiles for 2/3 DoF."""

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = 2.4477
HUBER_STEREO = 2.7955
FIXED_PRIOR = 1e12  # diagonal prior pinning fixed cameras
