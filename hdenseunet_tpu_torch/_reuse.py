"""The JAX package's framework-free files, loaded by path.

``hdenseunet_tpu.core``, ``.data`` and ``.infer`` import JAX in their
``__init__``, but three of their files are plain numpy: the typed config,
the NIfTI reader/writer and the host postprocess (which drives
``hdenseunet_tpu/native/postprocess.cpp``). Loading those files directly,
without their packages, keeps one source of truth for the config and the
byte-exact postprocess and pulls in no JAX.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_JAX_PKG = Path(__file__).resolve().parent.parent / "hdenseunet_tpu"


def _load(relpath: str):
    name = f"{__package__}._reused.{relpath.replace('/', '_')[:-3]}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _JAX_PKG / relpath)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses resolve annotations through it
    spec.loader.exec_module(module)
    return module


config = _load("core/config.py")
postprocess = _load("infer/postprocess.py")
nifti = _load("data/nifti.py")

Config = config.Config
InferConfig = config.InferConfig
ModelConfig = config.ModelConfig
