"""Reference scenes converted into the port, and the port's import
hygiene (split from test_torch_scene.py so that each file collects at
most nine tests).

`scene_from_arrays` takes a reference scene's leaves as numpy arrays and
must build the same Scene as the port's own builder; the port must import
without JAX, which the machine with the card does not have.
"""
import os
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.ops.megatrace import (
    mega_eligible, pack_mega_tables_torch,
)
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.scene.convert import scene_from_arrays
from test_torch_scene import _subset, jax_leaves, port_leaves

torch.set_num_threads(1)


def test_scene_from_arrays_equals_builder():
    arrays = _subset(jax_leaves(jax_cornell(64, 64, tall_box_material="glass")))
    conv = port_leaves(scene_from_arrays(arrays))
    built = port_leaves(cornell_box(64, 64, tall_box_material="glass"))
    for k, v in built.items():
        if isinstance(v, torch.Tensor):
            assert conv[k].dtype == v.dtype, k
            assert torch.equal(conv[k], v), k
        else:
            assert conv[k] == v, k
    for a, b in zip(pack_mega_tables_torch(scene_from_arrays(arrays)),
                    pack_mega_tables_torch(cornell_box(
                        64, 64, tall_box_material="glass"))):
        assert torch.equal(a, b)


def test_scene_from_arrays_names_unported_fields():
    arrays = _subset(jax_leaves(jax_cornell(16, 16)))
    arrays["materials.opacity"] = np.ones((5, 3), np.float32)
    with pytest.raises(NotImplementedError, match="materials.opacity"):
        scene_from_arrays(arrays)


def test_mega_eligible_names_missing_kind():
    """A reference scene outside the kernels' scope (a plastic tall box)
    converts, and the path kernel's eligibility check names the kind; a
    thin-lens config is in scope, a lens camera without its dims not."""
    ref = jax_cornell(16, 16, tall_box_material="plastic")
    scene = scene_from_arrays(_subset(jax_leaves(ref)))
    with pytest.raises(NotImplementedError, match=r"BSDF kinds \[4\]"):
        mega_eligible(scene, PathConfig(max_depth=3))
    assert mega_eligible(cornell_box(16, 16), PathConfig(max_depth=3))
    assert mega_eligible(cornell_box(16, 16), PathConfig(thinlens=True))
    lens = cornell_box(16, 16)
    lens.camera.aperture_radius = torch.tensor(10.0)
    with pytest.raises(NotImplementedError, match="thinlens=True"):
        mega_eligible(lens, PathConfig(max_depth=3))
    assert JPathConfig(max_depth=8).n_dims == PathConfig(max_depth=8).n_dims


def test_port_imports_no_jax():
    """Every port module imports without pulling in jax or the reference
    package (the machine with the card has no JAX)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "drmlt_mitsuba_tpu_torch")
    mods = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                mods.append(rel[:-3].replace(os.sep, ".").removesuffix(
                    ".__init__"))
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == "
        "'drmlt_mitsuba_tpu' or m.startswith('drmlt_mitsuba_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(" + repr(sorted(mods)) + "))\n")
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 29
    for m in ("integrators.bidir", "integrators.mmlt",
              "integrators.mmlt_grouped", "ops.megammlt", "ops.splat",
              "ops.megatrace", "render.film", "integrators.path",
              "scene.convert", "scene.xml", "scene.mesh_io", "scene.bvh",
              "ops.intersect", "utils.raybench"):
        assert "drmlt_mitsuba_tpu_torch." + m in mods
