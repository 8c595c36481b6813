"""The grouped driver's allocation of chains and steps to depth groups, in
both `equal_chains` schemes, vs the JAX reference.

The reference computes its schedule inline in
`render_drmlt_mmlt_grouped` (mmlt_grouped.py:224-246).  To read it for
given b_k without tracing anything, its per-group pieces are stubbed for
the length of one test: the fixed-depth trace and the bootstrap hand back
the chosen b_k, and the chain starts and the step leave the chains and the
film untouched; the driver's own schedule, loop and aux are the
reference's code.  The port's render with `equal_chains=False` is then
checked for its per-group normalisation with unequal chain counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drmlt_mitsuba_tpu.integrators.mmlt_grouped as jmg
from drmlt_mitsuba_tpu.integrators.bidir import BDPTConfig as JBDPTConfig
from drmlt_mitsuba_tpu.integrators.drmlt import DRMLTConfig as JDRMLTConfig
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu_torch.core.spectrum import luminance
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.drmlt import DRMLTConfig
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (
    group_schedule, render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.render import film
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box

torch.set_num_threads(1)

# (b_k per group, n_chains, n_steps, min_group): the 256x256 Cornell box
# and veach door at depth 6 as the H100 runs measured them (k = 1 carries
# no light on the door), and a group whose share rounds to nothing
SCHEDULES = {
    "cornell": ([0.0962, 0.04264, 0.01924, 0.009442, 0.004123, 0.002163],
                65536, 256, 1024),
    "veach": ([0.0, 0.00345, 0.003682, 0.003317, 0.002591, 0.00212],
              65536, 256, 1024),
    "tiny_group": ([0.5, 1e-6, 0.2], 4096, 24, 256),
}


def _reference_schedule(monkeypatch, b_ks, n_chains, n_steps, min_group,
                        equal_chains):
    """(sizes, steps_per_group) of the reference driver for these b_k."""
    def fixed_trace(scene, k, light_image=True, force_xla=False,
                    thinlens=False, medium=False):
        return k, JBDPTConfig(max_depth=k, light_image=light_image), 2

    def bootstrap(trace, root_key, n_dims, n_boot, batch=8192):
        return None, b_ks[trace - 1], None

    def step(trace_k, dcfg, film_cfg, frozen, carry, key, **kw):
        return carry, jnp.zeros(())

    monkeypatch.setattr(jmg, "make_mmlt_trace_fixed", fixed_trace)
    monkeypatch.setattr(jmg, "_group_bootstrap", bootstrap)
    monkeypatch.setattr(jmg, "_group_starts", lambda *a: None)
    monkeypatch.setattr(jmg, "drmlt_step", step)
    _, aux = jmg.render_drmlt_mmlt_grouped(
        None, JBDPTConfig(max_depth=len(b_ks)),
        JDRMLTConfig(type="orbital", n_chains=n_chains, splat_mode="three"),
        jfilm.make_film_config(8, 8, "box"), jax.random.PRNGKey(0), n_steps,
        min_group=min_group, equal_chains=equal_chains)
    return aux["sizes"], aux["steps_per_group"]


@pytest.mark.parametrize("equal_chains", [True, False])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_group_schedule_matches_reference(monkeypatch, case, equal_chains):
    b_ks, n_chains, n_steps, min_group = SCHEDULES[case]
    ref = _reference_schedule(monkeypatch, b_ks, n_chains, n_steps,
                              min_group, equal_chains)
    got = group_schedule(b_ks, n_chains, n_steps, equal_chains, min_group)
    assert got == (list(ref[0]), list(ref[1]))
    sizes, steps = got
    if not equal_chains:
        assert all(s % min_group == 0 for s in sizes)
        assert len({s for s in sizes if s}) > 1       # unequal chain counts


def test_grouped_render_unequal_chains_normalises_each_group():
    """16x16 box, depth 2, 1024 chains in multiples of 256, 16 steps per
    group.  With the sampled splat every mutation adds one sample of unit
    luminance, so a group normalised by its own chain count N_k has mean
    luminance b_k exactly; one normalised by n_chains would not."""
    w = h = 16
    depth, n_chains, min_group, n_steps = 2, 1024, 256, 16
    cfg = DRMLTConfig(type="orbital", n_chains=n_chains, n_bootstrap=16384,
                      splat_mode="sampled")
    img, aux = render_drmlt_mmlt_grouped(
        cornell_box(w, h), BDPTConfig(max_depth=depth), cfg,
        film.make_film_config(w, h, "box"), torch.Generator().manual_seed(7),
        n_steps, min_group=min_group, equal_chains=False)
    sizes, steps = group_schedule(aux["b_k"], n_chains, n_steps, False,
                                  min_group)
    assert aux["sizes"] == sizes and aux["steps_per_group"] == steps
    assert steps == [n_steps] * depth
    assert sorted(aux["images"]) == [1, 2]
    assert len(set(sizes)) > 1 and n_chains not in sizes
    torch.testing.assert_close(img, sum(aux["images"].values()))
    for k, im in aux["images"].items():
        assert aux["steps_eff"][k] == 16
        np.testing.assert_allclose(float(luminance(im).double().mean()),
                                   aux["b_k"][k - 1], rtol=1e-4)
    assert bool(torch.isfinite(img).all())
