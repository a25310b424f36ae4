"""TSV thermo reporter in the reference's StateDataReporter log format (port
of gamd_tpu/md/reporters.py, byte for byte the same file).

Tab-separated columns '#"Step" "Time (ps)" "Kinetic Energy (kJ/mole)"
"Temperature (K)"' every report interval, which the analysis notebooks
parse.
"""

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class StateReporter:
    """Write per-step thermo arrays to a StateDataReporter-compatible TSV."""

    def __init__(self, path, report_interval=100, dt_fs=2.0,
                 potential_energy=False):
        self.path = path
        self.report_interval = report_interval
        self.dt_fs = dt_fs
        self.potential_energy = potential_energy

    def write(self, thermo, start_step=0, potential=None):
        """Args:
            thermo: md.simulate.Thermo with per-step arrays (tensors on any
                device, or numpy).
            start_step: step offset for resumed runs.
            potential: optional [steps] PE array (classical runs).

        Returns the number of rows written.
        """
        ke = _host(thermo.kinetic_energy)
        temp = _host(thermo.temperature)
        if self.potential_energy:
            potential = _host(potential)
        cols = ['#"Step"', '"Time (ps)"']
        if self.potential_energy:
            cols.append('"Potential Energy (kJ/mole)"')
        cols += ['"Kinetic Energy (kJ/mole)"', '"Temperature (K)"']
        lines = ["\t".join(cols)]
        for i in range(self.report_interval - 1, ke.shape[0],
                       self.report_interval):
            step = start_step + i + 1
            row = [str(step), f"{step * self.dt_fs * 1e-3:.6f}"]
            if self.potential_energy:
                row.append(f"{float(potential[i]):.6f}")
            row += [f"{float(ke[i]):.6f}", f"{float(temp[i]):.6f}"]
            lines.append("\t".join(row))
        with open(self.path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return len(lines) - 1
