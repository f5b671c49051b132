"""Package rules of the PyTorch/CUDA port ``paddle_tpu_torch``.

The port imports neither JAX nor anything of the JAX package, names
neither in its sources, and its entry points run on the card unless the
caller asks for the CPU: without a GPU the default ``device="cuda"``
raises instead of running on the CPU.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.core import dtypes, native_build

PKG = pathlib.Path(paddle_tpu_torch.__file__).parent
REPO = PKG.parent


def _submodules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    mods = _submodules()
    for m in ("kernels.attention", "kernels.fused_update", "optimizer",
              "optimizer.clip", "optimizer.lr_scheduler", "ops.loss",
              "kernels.tiles", "kernels.conv_fused", "kernels.epilogues",
              "amp", "initializer", "models.resnet", "bench"):
        assert f"paddle_tpu_torch.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_name_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"\bjax\b|paddle_tpu\.")
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    names = {p.name for p in files}
    assert {"flash_fwd.cu", "flash_bwd.cu", "flash_common.cuh",
            "fused_update.cu", "brgemm.cu", "conv_kxk.cu",
            "igemm.cuh"} <= names
    offenders = []
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line):
                offenders.append(f"{path.relative_to(REPO)}:{n}: {line}")
    assert not offenders, "\n".join(offenders)


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from paddle_tpu_torch.inference import GenerationConfig, Generator
    from paddle_tpu_torch.models import Transformer, TransformerConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device()
    cfg = TransformerConfig.tiny(n_layer=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(cfg)
    model = Transformer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator(model, GenerationConfig(max_len=8, src_len_buckets=(8,)))
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        port_device.resolve_device("meta")


def test_strict_float32_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    port_device.strict_float32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("name,dtype", [("bfloat16", torch.bfloat16),
                                        ("float32", torch.float32),
                                        ("int32", torch.int32),
                                        ("bool", torch.bool)])
def test_dtype_names_round_trip(name, dtype):
    assert dtypes.convert_dtype(name) is dtype
    assert dtypes.convert_dtype(dtype) is dtype
    assert dtypes.dtype_name(dtype) == name


def test_unknown_dtype_raises():
    with pytest.raises(ValueError):
        dtypes.convert_dtype("float8")


def test_kernel_library_path_tracks_the_source_hash(tmp_path, monkeypatch):
    """An edited source maps to a new library name (so it is rebuilt);
    an unchanged one to the same name (so it is loaded as built)."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(native_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "_build"))
    first = native_build._lib_path("k")
    assert first == native_build._lib_path("k")
    assert os.path.dirname(first) == str(tmp_path / "_build")
    (src / "k.cu").write_text("// v2\n")
    assert native_build._lib_path("k") != first
    (src / "common.cuh").write_text("// header\n")
    assert native_build._lib_path("k") not in (first,)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native_build.nvcc_path()


def test_kernel_build_directory_is_ignored_by_git():
    ignore = (REPO / ".gitignore").read_text().splitlines()
    assert "paddle_tpu_torch/_build/" in ignore
    assert os.path.relpath(native_build.BUILD_DIR, REPO) == \
        os.path.join("paddle_tpu_torch", "_build")


def test_embedding_squeezes_trailing_id_dim():
    from paddle_tpu_torch.ops.nn_ops import embedding
    table = torch.from_numpy(np.arange(12, dtype=np.float32).reshape(6, 2))
    ids = torch.tensor([[1], [4]])
    assert embedding(ids, table).shape == (2, 2)
    out = embedding(torch.tensor([[0, 3]]), table, padding_idx=0)
    assert out.shape == (1, 2, 2) and (out[0, 0] == 0).all()
