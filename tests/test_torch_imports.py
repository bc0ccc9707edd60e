"""The port stands alone: importing any of ``repro_torch`` loads neither
``jax`` nor the JAX package ``repro``, no port source (nor a script that
drives it on the GPU, nor an example twin) imports them, and the
deployment's entry points (``default_deployment``, the admin CLI, the
example twins) run on the GPU unless the caller asks for the CPU."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import api, engines, interop
from repro_torch.stream.engine import StreamEngine
from repro_torch.stream.ml import MLEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the port, the scripts that drive it on the card, and the example twins
SOURCES = (sorted(PORT.rglob("*.py"))
           + [ROOT / name for name in ("chip_smoke.py", "scan_variants.py",
                                       "stream_ab.py")]
           + sorted((ROOT / "examples").glob("*_torch.py")))
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(len(names), loaded)
"""


def test_importing_the_port_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    count, loaded = proc.stdout.split(" ", 1)
    assert int(count) >= 43
    assert loaded.strip() == "[]"


STREAM_MODULES = ["repro_torch.stream", "repro_torch.stream.spec",
                  "repro_torch.stream.engine", "repro_torch.stream.shim",
                  "repro_torch.stream.compile",
                  "repro_torch.stream.continuous",
                  "repro_torch.kernels.stream.ops",
                  "repro_torch.kernels.stream.ref",
                  "repro_torch.kernels.stream.stream"]


ML_MODULES = ["repro_torch.models.config", "repro_torch.models.layers",
              "repro_torch.models.attention", "repro_torch.models.lm",
              "repro_torch.models.registry", "repro_torch.models.convert",
              "repro_torch.sharding.logical", "repro_torch.serve.engine",
              "repro_torch.stream.ml", "repro_torch.configs.qwen2_1_5b",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.flash_attention.ref",
              "repro_torch.kernels.flash_attention.flash_attention"]


# the encoder-decoder family and the crash-safe streams
DURABLE_MODULES = ["repro_torch.models.encdec",
                   "repro_torch.configs.seamless_m4t_medium",
                   "repro_torch.runtime.fault",
                   "repro_torch.checkpoint.manager",
                   "repro_torch.stream.durability"]


# the serving front door and the admin interface
FRONTDOOR_MODULES = ["repro_torch.serve.frontdoor",
                     "repro_torch.core.islands", "repro_torch.core.admin"]


# the training path, imported by submodule (a package directory alone
# would import as a namespace package)
TRAIN_MODULES = ["repro_torch.optim.adamw", "repro_torch.train.step",
                 "repro_torch.data.pipeline"]


# the sharded path and the launch layer
LAUNCH_MODULES = ["repro_torch.sharding", "repro_torch.launch.mesh",
                  "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                  "repro_torch.launch.drive_dryrun",
                  "repro_torch.launch.hillclimb"]


@pytest.mark.parametrize("module",
                         STREAM_MODULES + ML_MODULES + DURABLE_MODULES
                         + FRONTDOOR_MODULES + TRAIN_MODULES
                         + LAUNCH_MODULES)
def test_streaming_modules_load_no_jax(module):
    """Each module of the streaming, ML and durability slices, imported
    alone in a fresh interpreter, loads neither jax nor the reference
    package."""
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_port_source_imports_jax_or_reference(path):
    assert not FORBIDDEN.findall(path.read_text()), path


def test_forbidden_pattern_catches_each_spelling():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import api", "import repro",
                 "    from repro.kernels.quant_cast import ops"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import api",
                 "import jaxtyping_free", "# import jax"):
        assert not FORBIDDEN.search(line), line


def test_default_deployment_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.default_deployment()
    bd = api.default_deployment(device="cpu")
    assert bd.device == torch.device("cpu")
    assert {e.device for e in bd.engines.values()} == {torch.device("cpu")}


@pytest.mark.parametrize("cls", [engines.HostStoreEngine,
                                 engines.DenseHBMEngine,
                                 engines.KVStoreEngine,
                                 engines.ReplicatedEngine, StreamEngine,
                                 MLEngine])
def test_engines_built_alone_run_on_the_card(monkeypatch, cls):
    """An engine built without a deployment defaults to the GPU too: with
    none it raises as default_deployment does, and "cpu" is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cls("e0")
    assert cls("e0", device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cls("e0").device == torch.device("cuda")


@pytest.mark.parametrize("entry", ["admin", "quickstart",
                                   "streaming_mimic", "train_lm"])
def test_cli_entry_points_run_on_the_card(monkeypatch, entry):
    """The admin CLI and the example twins build their deployments on
    the GPU unless ``--device cpu`` is given: without one they raise."""
    import importlib.util

    from repro_torch.core import admin
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "admin":
        main = admin.main
    else:
        path = ROOT / "examples" / f"{entry}_torch.py"
        spec = importlib.util.spec_from_file_location(f"_{entry}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        main = module.main
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(["status"] if entry == "admin" else [])


def test_interop_from_numpy_names_its_device():
    with pytest.raises(TypeError, match="device"):
        interop.from_numpy({"kind": "table", "columns": {}})
    t = interop.from_numpy(np.arange(3), "cpu")
    assert t.device == torch.device("cpu") and t.dtype == torch.int64
