"""The plain reference that decides `correct`: a straightforward Gaussian
rasterizer in plain PyTorch (camera matrices, preprocess and SH, tile
binning with the configuration's caps, the blend's forward and its
gradient written out, the masked L1 + SSIM loss, autograd and Adam).

It is a frozen copy of the plain versions of photo_slam_tpu_torch at
commit b2b746adc8850e97c8bf961cd6f4acbaa347c7b1 (ops/camera_math.py,
ops/preprocess.py, ops/sh.py, ops/binning.py, ops/tiled.py, ops/blend.py,
ops/losses.py, models/optimizer.py), trimmed to the paths the benchmark's
cells run, and imports nothing of that package: later changes to the
program cannot move it.

`prec` selects the precision of the reference's products (the camera
transforms' matrix products and SSIM's blur): "f32", as the configurations
state, or "tf32", the control, whose operands are rounded to TF32's 10-bit
mantissa first, as the tensor cores round them.
"""
