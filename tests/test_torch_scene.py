"""Port scene construction vs the JAX reference, leaf for leaf.

The port (drmlt_mitsuba_tpu_torch) builds its Cornell box and veach door
and packs its kernel tables without importing JAX; these tests hold each
of those against the reference package on the same inputs.  Exact
equality: both sides run the same numpy host code.  Scene conversion and
the port's import hygiene are in test_torch_scene_convert.py.
"""
import dataclasses

import jax.numpy as jnp  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.ops.pallas.megatrace import (
    pack_mega_tables as jax_pack,
)
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu.scene.builders import veach_door as jax_veach
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.ops.megatrace import (
    mega_eligible, pack_mega_tables_torch,
)
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box, veach_door

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


def assert_tables_equal(got, ref):
    """The port's ten tables equal the reference's, bit for bit; the
    reference pads tri_ext (the sixth) to a multiple of 512 rows with
    zeros, the port does not."""
    assert len(got) == 10 and len(ref) == 10
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        if i == 5:
            assert not b[a.shape[0]:].any()
            b = b[:a.shape[0]]
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      b.view(np.uint32))


@pytest.mark.parametrize("tall", TALL)
def test_pack_mega_tables_matches_reference(tall):
    assert_tables_equal(
        pack_mega_tables_torch(cornell_box(32, 32, tall_box_material=tall)),
        jax_pack(jax_cornell(32, 32, tall_box_material=tall)))


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
    assert_tables_equal(pack_mega_tables_torch(veach_door(64, 48)),
                        jax_pack(jax_veach(64, 48)))
    assert mega_eligible(veach_door(8, 8), PathConfig(max_depth=3))
