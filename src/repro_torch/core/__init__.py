"""Core StreamSVM library of the port: ball algebra, Algorithms 1 and 2
for one model and for a bank, multiclass and C-grid fitting, the streaming
drivers and the readouts, and the kernelized bank (Sec 4.2) with its
Sec-4.3 merges."""
from .kernel_bank import (
    KernelBank,
    fit_kernel_bank,
    kernel_bank_decision,
    save_kernel_bank,
)
from .kernelized import KernelBall, fit_kernelized, linear_kernel, linear_weights, rbf_kernel
from .meb import (
    Ball,
    center_distance,
    enclose_point,
    fold_banks,
    fold_kernel_banks,
    fold_merge,
    make_ball,
    merge_balls,
    merge_banks,
    merge_kernel_banks,
    nonfinite_rows,
    point_distance,
    stack_banks,
    stack_kernel_banks,
)
from .multiball import bank_stack, bank_take, fit_bank
from .multiclass import fit_c_grid, fit_ovr, ovr_signs, predict_c_grid, predict_ovr
from .qp import solve_meb_ball_points
from .streamsvm import (
    StreamCheckpoint,
    accuracy,
    decision_function,
    fit,
    fit_ball,
    fit_chunked,
    fit_chunked_many,
    fit_lookahead,
    fit_lookahead_ball,
    init_ball,
    predict,
)

__all__ = [
    "Ball",
    "KernelBall",
    "KernelBank",
    "StreamCheckpoint",
    "accuracy",
    "bank_stack",
    "bank_take",
    "center_distance",
    "decision_function",
    "enclose_point",
    "fit",
    "fit_ball",
    "fit_bank",
    "fit_c_grid",
    "fit_chunked",
    "fit_chunked_many",
    "fit_kernel_bank",
    "fit_kernelized",
    "fit_lookahead",
    "fit_lookahead_ball",
    "fit_ovr",
    "fold_banks",
    "fold_kernel_banks",
    "fold_merge",
    "init_ball",
    "kernel_bank_decision",
    "linear_kernel",
    "linear_weights",
    "make_ball",
    "merge_balls",
    "merge_banks",
    "merge_kernel_banks",
    "nonfinite_rows",
    "ovr_signs",
    "point_distance",
    "predict",
    "predict_c_grid",
    "predict_ovr",
    "rbf_kernel",
    "save_kernel_bank",
    "solve_meb_ball_points",
    "stack_banks",
    "stack_kernel_banks",
]
