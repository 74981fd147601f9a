"""The blend experiments, ported: the counterparts of tools/exp_blend16.py
(X4, the 16x16 quadrant blend forward and backward), tools/exp_blend_vec.py
(X3, the group-vectorized blend), tools/exp_vpu_dtype.py (X2, the f32 and
bf16 throughput probe) and tools/exp_blend_bf16.py (X1, the bf16 blend),
each with its kernels written for Hopper (csrc/), and bench_room.py, the
room scene they run on. Each module runs as a script:

    python -m photo_slam_tpu_torch.tools.exp_blend16 [--device cpu]
"""
