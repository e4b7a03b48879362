"""``k3.hbm_pct`` (%; layer ``kernels/gather_spmm.py`` + ``csrc/bsr_spmm.cu``;
device trace): K3's least bytes in one profiled solve
(``yardstick.bytes_bsr_least``: each stored block's values and one int32
index, X and Y once, at each call's operand and block rows) over the device
time of K3's records, as a share of the published 3.35 TB/s."""

from solvebench.rooflines import hbm_pct
from solvebench.yardstick import bytes_bsr_least

UNIT = "%"
WRAPPER = "bsr_spmm_t_cuda"
KERNELS = ("bsr_spmm_t_kernel",)


def least_bytes(call):
    return bytes_bsr_least(call["nnzb"], call["n"], call["m"], call["itemsize"], call["block"])


def read(run):
    return hbm_pct(run, WRAPPER, KERNELS, least_bytes)
