"""instruct_tpu_torch -- the PyTorch/CUDA port of ``instruct_tpu``.

Bayesian population-structure inference (the InStruct model family, Gao,
Williamson & Bustamante 2007) on an NVIDIA GPU: plain tensor code in
PyTorch, and a hand-written CUDA kernel (``csrc/``, built with ``nvcc`` at
first use, bound with ``ctypes``) wherever the JAX package has a Pallas
kernel.  The package imports ``torch`` and numpy only, never ``jax`` and
nothing of ``instruct_tpu``.

Ported: everything the JAX package runs except its GSPMD mesh mode -- the
diploid modes 0-5 (no admixture, admixture, population- and
individual-level selfing, population- and individual-level inbreeding;
uniform and normal prior, back-reflection and adaptive-independence
proposal, any number of pops and alleles) on packed biallelic and on
multi-allelic panels, end to end through :func:`run_mcmc`, as a fused and an
unfused sweep (``mcmc/step.py``); the tetraploid engine, auto- and
allotetraploid (``tetra/engine.py``); the selection of K,
:func:`infer_k`, as one padded (chain x K) grid (``kselect.py``); and the
command line, ``python -m instruct_tpu_torch -d panel.txt -o out.txt ...``
(``cli.py``), from a genotype file (:func:`read_data`) to the InStruct
report (:func:`write_report`), with checkpoint/resume, progress and a JSONL
log; the gradient samplers (``samplers/``: HMC, NUTS, SVI and SMC on the
marginalized posterior, ``--sampler``); and chain and loci sharding over
``torch.distributed``, one process a rank (``parallel/``:
``run_mcmc(mesh=make_mesh(C, D))``, ``infer_k(mesh=...)``, the command
line's ``--chain-shards``, ``--data-shards`` and ``--coordinator`` /
``--num-processes`` / ``--process-id``).
Sub-packages and functions keep the names of their counterparts in
``instruct_tpu``.  Entry points run on ``device="cuda"`` unless the caller
asks for the CPU, where the kernels' plain PyTorch versions run instead.
"""

from instruct_tpu_torch.config import ModelSpec, Schedule, Priors
from instruct_tpu_torch.data.dataset import Dataset, Panel
from instruct_tpu_torch.data.loader import read_data, write_panel
from instruct_tpu_torch.data.synthetic import synthetic_panel
from instruct_tpu_torch.mcmc.driver import run_mcmc, RunResult
from instruct_tpu_torch.kselect import infer_k, KSelectResult
from instruct_tpu_torch.report import write_report

__version__ = "0.1.0"

__all__ = [
    "ModelSpec",
    "Schedule",
    "Priors",
    "Dataset",
    "Panel",
    "synthetic_panel",
    "run_mcmc",
    "RunResult",
    "infer_k",
    "KSelectResult",
    "read_data",
    "write_panel",
    "write_report",
    "__version__",
]
