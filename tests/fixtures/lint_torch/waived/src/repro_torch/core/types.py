from typing import NamedTuple


class SimMetrics(NamedTuple):
    total_energy_j: float
    # spars-lint: ignore[PL006] a legacy view, summarized by total_energy_j
    energy_by_state_j: tuple

    def row(self):
        return {"total_energy_kwh": self.total_energy_j / 3.6e6}
