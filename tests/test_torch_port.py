"""Package rules of the PyTorch/CUDA port: it imports neither jax nor the
JAX package, its host modules are byte-for-byte copies of the JAX
package's, its constant tables equal the JAX package's, its kernels are
built only at their first launch and launched only for CUDA tensors, and
chip_smoke.py refuses to run without a card or without the package."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ks265codec_tpu_torch"
REF = ROOT / "ks265codec_tpu"

HOST_COPIES = [
    "bitstream/bitio.py", "bitstream/nal.py", "bitstream/cabac.py",
    "hevc/tables.py", "hevc/cabac_tables.py", "hevc/params.py",
    "hevc/slicehdr.py", "hevc/sei.py", "native/__init__.py",
    "native/cabac.c", "decode/recon.py", "decode/slice_dec.py",
    "encode/config.py", "encode/map_writer.py", "encode/sbac.py",
    "utils/yuv.py", "utils/trace.py", "encode/sao.py", "utils/log.py",
    "decode/filters.py", "utils/pool.py", "utils/md5.py", "cli/__init__.py",
    "encode/gop.py", "encode/rc.py", "encode/merge_vec.py", "decode/inter.py",
    "encode/bitcounter.py",
]


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copy_is_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes(), rel


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_import(path):
    for mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ks265codec_tpu"), (path, mod)


def test_port_imports_with_jax_blocked():
    """Every port module imports in a fresh interpreter where `import jax`
    fails, and none of them pulls in the JAX package."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'ks265codec_tpu'"
        " or m.startswith('ks265codec_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_tables_from_numpy_matches_reference_tables():
    from ks265codec_tpu.hevc import tables as T
    from ks265codec_tpu_torch.interop import port_tables, tables_from_numpy
    ref = tables_from_numpy(T.DCT, T.QUANT_SCALE, T.LEVEL_SCALE,
                            T.INTRA_PRED_ANGLE, T.INV_ANGLE, T.BETA_TABLE,
                            T.TC_TABLE, [T.chroma_qp(i) for i in range(80)])
    assert np.array_equal(port_tables(), ref)


def test_tables_from_numpy_rejects_wrong_sizes():
    from ks265codec_tpu.hevc import tables as T
    from ks265codec_tpu_torch.interop import tables_from_numpy
    with pytest.raises(ValueError, match="beta"):
        tables_from_numpy(T.DCT, T.QUANT_SCALE, T.LEVEL_SCALE,
                          T.INTRA_PRED_ANGLE, T.INV_ANGLE, T.BETA_TABLE[:-1],
                          T.TC_TABLE, [T.chroma_qp(i) for i in range(80)])


def test_kernels_build_at_first_launch_not_at_import():
    code = (
        "import importlib, pathlib\n"
        "root = pathlib.Path('ks265codec_tpu_torch')\n"
        "for p in sorted(root.rglob('*.py')):\n"
        "    importlib.import_module('.'.join(p.with_suffix('').parts))\n"
        "from ks265codec_tpu_torch.ops import _build\n"
        "assert _build._lib is None\n"
        "assert _build.BUILD_DIR.parts[-2:] == ('build', "
        "'ks265_torch_kernels')\n"
        "assert '-gencode=arch=compute_90a,code=sm_90a' in _build.CUDA_FLAGS\n"
        "assert '--fmad=false' in _build.CUDA_FLAGS\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_cpu_encode_launches_no_kernel():
    """CPU tensors run the plain versions; no launch is counted."""
    from ks265codec_tpu_torch.encode.config import EncoderConfig
    from ks265codec_tpu_torch.encode.encoder import encode_sequence
    from ks265codec_tpu_torch.ops import _build
    from ks265codec_tpu_torch.utils.yuv import YUVFrame
    rng = np.random.RandomState(3)
    frame = YUVFrame(rng.randint(0, 256, (64, 64), dtype=np.uint8),
                     rng.randint(0, 256, (32, 32), dtype=np.uint8),
                     rng.randint(0, 256, (32, 32), dtype=np.uint8), poc=0)
    _build.reset_launches()
    data, _ = encode_sequence(
        [frame], EncoderConfig(width=64, height=64, preset="ultrafast",
                               qp=27, intra_period=1, sao=0), device="cpu")
    assert len(data) > 0
    assert _build.launches == {}


@pytest.mark.parametrize("where", ["repo_without_card", "script_alone"])
def test_chip_smoke_fails_without_card_or_package(where, tmp_path):
    """No card (CUDA hidden), or chip_smoke.py copied away from the
    package: a nonzero exit and no result line."""
    env, cwd = dict(os.environ, CUDA_VISIBLE_DEVICES=""), ROOT
    if where == "script_alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        env, cwd = dict(os.environ), tmp_path
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
