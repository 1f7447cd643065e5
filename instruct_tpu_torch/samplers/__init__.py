from instruct_tpu_torch.samplers.potential import MarginalModel
from instruct_tpu_torch.samplers.hmc import run_hmc
from instruct_tpu_torch.samplers.svi import run_svi
from instruct_tpu_torch.samplers.smc import run_smc

__all__ = ["MarginalModel", "run_hmc", "run_svi", "run_smc"]
