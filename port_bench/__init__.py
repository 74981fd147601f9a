"""The benchmark of photo_slam_tpu_torch on one H100:
`python3 -m port_bench.run` (see run.py)."""
