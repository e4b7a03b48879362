"""``k1.hbm_pct`` (%; layer ``kernels/dia_spmm.py`` + ``csrc/dia_spmm.cu``;
device trace): K1's least bytes in one profiled solve
(``yardstick.bytes_spmm_dia`` at each call's n, diagonals, block rows and
item size) over the device time of K1's records, as a share of the
published 3.35 TB/s. The card's power limit is in the result's ``device``."""

from solvebench.rooflines import hbm_pct
from solvebench.yardstick import bytes_spmm_dia

UNIT = "%"
WRAPPER = "dia_spmm_t_cuda"
KERNELS = ("dia_spmm_t_vec_kernel", "dia_spmm_t_scalar_kernel")


def least_bytes(call):
    return bytes_spmm_dia(call["n"], call["ndiag"], call["m"], call["itemsize"])


def read(run):
    return hbm_pct(run, WRAPPER, KERNELS, least_bytes)
