"""PyTorch + CUDA port of `fcc_qp_tpu`: batched friction-cone QP solves
on an NVIDIA H100.

The JAX package `fcc_qp_tpu` is the reference this package is held
against; this package imports nothing of it (nor JAX). Entry points run
on the card unless the caller asks for the CPU (``device="cpu"``).

Importing the package pins float32 matrix products to full f32 (no
TF32): the Newton-Schulz inverse seeds do not contract under a
10-bit-mantissa product, and the polish then fails without a sign.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape  # noqa: E402
from fcc_qp_tpu_torch.core.api import FCCQP  # noqa: E402
from fcc_qp_tpu_torch.core.batched import solve_batched_fast  # noqa: E402
from fcc_qp_tpu_torch.core.ds_engine import (  # noqa: E402
    OperatorCache,
    QPBatchDS,
    WarmStartDS,
    operator_cache_from_numpy,
    replay_ds,
    replay_ds_streams,
    solve_batched_ds,
    to_ds_batch,
    warm_start_f64_from_numpy,
    warm_start_from_numpy,
)
from fcc_qp_tpu_torch.core.serving import FCCQPServer  # noqa: E402
from fcc_qp_tpu_torch.core.solver import (  # noqa: E402
    replay,
    solve,
    solve_batched,
)
from fcc_qp_tpu_torch.types import (  # noqa: E402
    FCCQPDetails,
    FCCQPSolution,
    FCCQPSolveStatus,
    QPBatch,
    WarmStart,
)

__all__ = [
    "FCCQP",
    "FCCQPServer",
    "QPBatch",
    "WarmStart",
    "solve",
    "solve_batched",
    "solve_batched_fast",
    "replay",
    "FCCQPOptions",
    "ProblemShape",
    "FCCQPDetails",
    "FCCQPSolution",
    "FCCQPSolveStatus",
    "OperatorCache",
    "QPBatchDS",
    "WarmStartDS",
    "operator_cache_from_numpy",
    "replay_ds",
    "replay_ds_streams",
    "solve_batched_ds",
    "to_ds_batch",
    "warm_start_f64_from_numpy",
    "warm_start_from_numpy",
]
