from typing import NamedTuple


class SimMetrics(NamedTuple):
    total_energy_j: float
    peak_power_w: float

    def row(self):
        return {"total_energy_kwh": self.total_energy_j / 3.6e6}
