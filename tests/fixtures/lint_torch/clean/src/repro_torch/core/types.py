from typing import NamedTuple


class SimMetrics(NamedTuple):
    total_energy_j: float
    n_jobs: int

    def _jobs(self):
        return self.n_jobs

    def row(self):
        return {"total_energy_kwh": self.total_energy_j / 3.6e6, "n_jobs": self._jobs()}
