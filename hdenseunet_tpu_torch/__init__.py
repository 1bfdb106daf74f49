"""hdenseunet_tpu_torch — the PyTorch/CUDA port of hdenseunet_tpu for one H100.

The JAX package beside it is the reference: every module here mirrors the
name of its JAX counterpart and is tested against it on the same weights and
inputs. This slice ports the serving path:

core     seeded initializers and the parameter bridge from the JAX pytree
ops      K1, the fused frozen BN∘Scale∘ReLU (CUDA, csrc/fused_affine.cu),
         and the nvcc/ctypes build of csrc/
models   layer kit, 2D DenseUNet-167, 3D DenseUNet, H-DenseUNet hybrid
infer    device-resident sliding-window scorer and the volume predictor

The config, NIfTI IO and host postprocess are the JAX package's own
framework-free files, loaded by path (``_reuse``). Nothing here imports JAX.
"""
