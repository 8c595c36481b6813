"""Named statistics counters (counterpart of
drmlt_mitsuba_tpu/core/stats.py; the reference's StatsCounter kinds
ENumberValue / EPercentage / EAverage): the per-step series of an MCMC
render's stats, aggregated on the host into the reference's report."""
from __future__ import annotations

import numpy as np
import torch

PERCENTAGE = "percentage"
NUMBER = "number"
AVERAGE = "average"


def _host(series):
    if isinstance(series, torch.Tensor):
        return series.detach().cpu().numpy()
    return np.asarray(series)


class Statistics:
    """Host-side aggregate of per-step stat series."""

    def __init__(self):
        self._counters = {}

    def record(self, name: str, series, kind: str = AVERAGE):
        """Record a per-step series (a tensor or an array, (n_steps,))."""
        self._counters[name] = (kind, _host(series))

    def record_mcmc(self, stats: dict, n_chains: int):
        """Ingest the stats dict of render_drmlt / render_pssmlt (a1, a2,
        accept1, accept2, large / accept, large, one (n_steps,) series
        each); Mutations counts the first series' steps x n_chains."""
        mapping = {
            "accept": ("Overall acceptance rate", PERCENTAGE),
            "accept1": ("First stage acceptance rate", PERCENTAGE),
            "accept2": ("Second stage acceptance rate", PERCENTAGE),
            "a1": ("Mean first stage alpha", AVERAGE),
            "a2": ("Mean second stage alpha", AVERAGE),
            "large": ("Large step ratio", PERCENTAGE),
        }
        for key, (name, kind) in mapping.items():
            if key in stats:
                self.record(name, stats[key], kind)
        self.record("Mutations", np.asarray(
            [len(_host(next(iter(stats.values())))) * n_chains]), NUMBER)

    def report(self) -> str:
        lines = ["  ------------------------------------------------------"]
        for name, (kind, series) in sorted(self._counters.items()):
            if kind == PERCENTAGE:
                lines.append(f"  * {name}: {100.0 * float(series.mean()):.2f}%")
            elif kind == NUMBER:
                lines.append(f"  * {name}: {int(series.sum())}")
            else:
                lines.append(f"  * {name}: {float(series.mean()):.4f}")
        lines.append("  ------------------------------------------------------")
        return "\n".join(lines)

    def as_dict(self):
        return {name: (int(series.sum()) if kind == NUMBER
                       else float(series.mean()))
                for name, (kind, series) in self._counters.items()}
