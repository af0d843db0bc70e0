"""Mendelian randomization on the merged skeleton: multivariable IVW and the
competitor estimators (`cigwas_tpu.mr`); host numpy and scipy, no pandas."""

from cigwas_tpu_torch.mr.mvivw import run_mvivw, run_mvivw_filtered, mv_ivw_regression
from cigwas_tpu_torch.mr.cause import cause_fit, est_cause_params, run_cause_analyses
from cigwas_tpu_torch.mr.competitors import (
    gwas_associations,
    mr_egger,
    mr_ivw,
    mr_presso,
    run_mr_benchmark,
    run_pairwise_mr_analyses,
    run_presso_analyses,
)

__all__ = [
    "run_mvivw",
    "run_mvivw_filtered",
    "mv_ivw_regression",
    "gwas_associations",
    "mr_ivw",
    "mr_egger",
    "mr_presso",
    "run_pairwise_mr_analyses",
    "run_presso_analyses",
    "run_mr_benchmark",
    "cause_fit",
    "est_cause_params",
    "run_cause_analyses",
]
