"""hdenseunet_tpu_torch — the PyTorch/CUDA port of hdenseunet_tpu for one H100.

The JAX package beside it is the reference: every module here mirrors the
name of its JAX counterpart and is tested against it on the same weights and
inputs. Ported so far: the serving path, the training path, the staged
training workflow behind the command line (``python -m hdenseunet_tpu_torch``),
the measurement and audit tools, and data parallelism over
``torch.distributed`` (one process per card).

cli      synth-data, preprocess, train, test, evaluate
core     typed config, seeded initializers, the parameter bridge to and
         from the JAX pytree, the 'data' mesh and its batch helpers
         (``core/mesh.py``)
parallel the multi-process runtime (``parallel/multihost.py``): joins the
         process group from torchrun's environment, splits the global
         batch, places each rank's rows on its card
ops      K1, the fused frozen BN∘Scale∘ReLU with its backward
         (csrc/fused_affine.cu), K2, the weighted cross-entropy forward and
         backward (csrc/wce.cu), and the nvcc/ctypes build of csrc/
models   layer kit (inference and training semantics), 2D DenseUNet-167,
         3D DenseUNet, H-DenseUNet hybrid and its stage masks
infer    device-resident sliding-window scorer, volume predictor, host
         postprocess, metrics
train    losses, SGD-Nesterov with staged freezing, the trainer, checkpoints
data     NIfTI IO, offline preparation, the guided crop sampler, the
         prefetch pipeline, synthetic training batches
native   the sampler's and the host postprocess's C++ cores (g++, ctypes)
weights  warm-start weights by layer name, the Keras-HDF5 converter, the
         activation-parity dump and compare (``weights.parity``)
utils    the NaN guard of the training loop, conv FLOP accounting with
         the H100's bf16 peak (``utils.flops``), torch.profiler tracing
         and the program's spans and counters (``utils.profiling``)

The config, NIfTI IO, offline preparation, metrics, host postprocess and
both native cores are the port's own copies of the JAX package's
framework-free files. Nothing here imports
JAX or the JAX package.
"""
