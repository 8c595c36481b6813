"""Port scene construction vs the JAX reference, leaf for leaf.

The port (drmlt_mitsuba_tpu_torch) builds its Cornell box, packs its
kernel tables and converts reference scenes without importing JAX; these
tests hold each of those against the reference package on the same
inputs.  Exact equality: both sides run the same numpy host code.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.ops.pallas.megatrace import (
    pack_mega_tables as jax_pack,
)
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu.scene.builders import veach_door as jax_veach
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.ops.megatrace import (
    mega_eligible, pack_mega_tables,
)
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box, veach_door
from drmlt_mitsuba_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(1)

GROUPS = ("tris", "spheres", "materials", "emitters", "camera")
TALL = ["diffuse", "mirror", "glass"]


def jax_leaves(scene):
    """{"group.field": ndarray} of a reference Scene (None leaves and
    static python fields included as they are)."""
    out = {}
    for g in GROUPS:
        part = getattr(scene, g)
        for f in dataclasses.fields(part):
            v = getattr(part, f.name)
            out[f"{g}.{f.name}"] = (None if v is None else v if isinstance(
                v, (int, bool, tuple)) else np.asarray(v))
    return out


def port_leaves(scene):
    return {f"{g}.{f.name}": getattr(getattr(scene, g), f.name)
            for g in GROUPS for f in dataclasses.fields(getattr(scene, g))}


def _subset(arrays):
    """The reference leaves the port's Scene carries."""
    keys = port_leaves(cornell_box(8, 8)).keys()
    return {k: arrays[k] for k in keys}


@pytest.mark.parametrize("tall", TALL)
def test_cornell_box_matches_reference(tall):
    ref = jax_leaves(jax_cornell(48, 32, tall_box_material=tall))
    got = port_leaves(cornell_box(48, 32, tall_box_material=tall))
    assert got.keys() <= ref.keys()
    for k, v in got.items():
        r = ref[k]
        if isinstance(v, torch.Tensor):
            assert v.numpy().dtype == np.asarray(r).dtype, k
            np.testing.assert_array_equal(v.numpy(), np.asarray(r), err_msg=k)
        else:
            assert v == r, k
    # the slice's scene: 36 triangles, 5 materials, one two-triangle light
    assert got["tris.v0"].shape == (36, 3)
    assert got["materials.kind"].shape == (5,)
    assert got["emitters.kind"].shape == (2,)


@pytest.mark.parametrize("tall", TALL)
def test_pack_mega_tables_matches_reference(tall):
    ref = jax_pack(jax_cornell(32, 32, tall_box_material=tall))
    got = pack_mega_tables(cornell_box(32, 32, tall_box_material=tall))
    assert len(got) == len(ref) == 10
    for a, b in zip(got, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_veach_door_matches_reference():
    """The veach-door scene (rough-diffuse door): every leaf and every
    packed kernel table equal to the reference's."""
    ref = jax_leaves(jax_veach(64, 48))
    got = port_leaves(veach_door(64, 48))
    for k, v in got.items():
        if isinstance(v, torch.Tensor):
            assert v.numpy().dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]),
                                          err_msg=k)
        else:
            assert v == ref[k], k
    assert got["tris.v0"].shape == (24, 3)
    assert 12 in got["materials.kind"].tolist()       # rough diffuse
    for a, b in zip(pack_mega_tables(veach_door(64, 48)),
                    jax_pack(jax_veach(64, 48))):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert mega_eligible(veach_door(8, 8), PathConfig(max_depth=3))


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
    for a, b in zip(pack_mega_tables(scene_from_arrays(arrays)),
                    pack_mega_tables(cornell_box(64, 64,
                                                 tall_box_material="glass"))):
        np.testing.assert_array_equal(a, b)


def test_scene_from_arrays_names_unported_fields():
    arrays = _subset(jax_leaves(jax_cornell(16, 16)))
    arrays["textures.data"] = np.zeros((1, 2, 2, 3), np.float32)
    with pytest.raises(NotImplementedError, match="textures.data"):
        scene_from_arrays(arrays)


def test_mega_eligible_names_missing_kind():
    """A reference scene outside the slice (rough-conductor tall box)
    converts, and the path kernel's eligibility check names the kind."""
    ref = jax_cornell(16, 16, tall_box_material="roughconductor")
    scene = scene_from_arrays(_subset(jax_leaves(ref)))
    with pytest.raises(NotImplementedError, match=r"BSDF kinds \[3\]"):
        mega_eligible(scene, PathConfig(max_depth=3))
    assert mega_eligible(cornell_box(16, 16), PathConfig(max_depth=3))
    with pytest.raises(NotImplementedError, match="thin-lens"):
        mega_eligible(cornell_box(16, 16), PathConfig(thinlens=True))
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
    assert int(res.stdout.strip()) >= 19
    for m in ("integrators.bidir", "integrators.mmlt",
              "integrators.mmlt_grouped", "ops.megammlt"):
        assert "drmlt_mitsuba_tpu_torch." + m in mods
