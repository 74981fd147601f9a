"""photo_slam_tpu_torch: the PyTorch/CUDA port of photo_slam_tpu.

The package mirrors photo_slam_tpu's layout and function names (ops/,
models/, mapper/, tracking/, utils/, io/, apps/) so each function's JAX counterpart is found
under the same path. It imports torch and numpy, never jax: it runs on
machines that have no JAX. Every function works on the device of the
tensors it is given.

Four slices are ported: the serving render (preprocess, binning, the
blend forward; ops/render.py::render, apps/view_result.py), the training
step (the render's backward, SSIM, Adam, densify; mapper/trainer.py,
apps/train_colmap.py), the blend experiments X1-X4 (tools/) and the online
mapper with the ground-truth frontend (mapper/mapper.py,
tracking/gt_tracker.py, apps/online_slam.py, apps/replay_stream.py). Every TPU
kernel of the JAX package and its tools has a hand-written CUDA C++
counterpart for Hopper (csrc/, nine kernels, built by kernels.py at first
use); each has a plain PyTorch version beside its wrapper, which runs for
tensors on the CPU.
"""
