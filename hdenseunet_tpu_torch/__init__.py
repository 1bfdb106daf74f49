"""hdenseunet_tpu_torch — the PyTorch/CUDA port of hdenseunet_tpu for one H100.

The JAX package beside it is the reference: every module here mirrors the
name of its JAX counterpart and is tested against it on the same weights and
inputs. Ported so far: the serving path and the training path.

core     typed config, seeded initializers, the parameter bridge from the
         JAX pytree
ops      K1, the fused frozen BN∘Scale∘ReLU with its backward
         (csrc/fused_affine.cu), K2, the weighted cross-entropy forward and
         backward (csrc/wce.cu), and the nvcc/ctypes build of csrc/
models   layer kit (inference and training semantics), 2D DenseUNet-167,
         3D DenseUNet, H-DenseUNet hybrid and its stage masks
infer    device-resident sliding-window scorer, volume predictor, host
         postprocess
train    losses, SGD-Nesterov with staged freezing, the trainer
data     NIfTI IO, synthetic training batches
native   the host postprocess's C++ core (g++, ctypes)
utils    the NaN guard of the training loop

The config, NIfTI IO, host postprocess and its native core are the port's
own copies of the JAX package's framework-free files. Nothing here imports
JAX or the JAX package.
"""
