"""Deployment cost model (paper §6, Tables 2 and 3) + H100 re-parameterisation.

Port of ``repro.core.cost_model``. Reproduces the paper's numbers exactly
from its stated unit prices, then applies the same balance analysis to an
H100 deployment: the central phenomenon is CPU<->accelerator imbalance — a
host that cannot generate enough load wastes the accelerator and can make
the accelerated system MORE expensive than CPU-only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

HOURS_PER_YEAR = 24 * 365

# paper Table 2 cloud unit prices ($/hour), named so the serving-layer
# cost report prices measured throughput through the same numbers
AWS_C5_12XLARGE_USD_H = 1.452     # 48 vCPUs, CPU-only baseline
AWS_F1_2XLARGE_USD_H = 1.2266     # 8 vCPUs + 1 FPGA
AZURE_F48SV2_USD_H = 1.2084       # 48 vCPUs
AZURE_NP10S_USD_H = 1.0411        # 10 vCPUs + 1 FPGA


def aws_host_usd_per_hour(vcpus: int) -> float:
    """Host-only $/hour for a ``vcpus``-core box, pro-rated from the
    c5.12xlarge (48 vCPUs) — the paper's CPU price anchor."""
    return AWS_C5_12XLARGE_USD_H * (vcpus / 48.0)


def aws_accel_usd_per_hour() -> float:
    """Accelerator-only $/hour: the f1.2xlarge price minus its 8-vCPU
    host share — what one attached FPGA costs on top of whatever host
    feeds it."""
    return AWS_F1_2XLARGE_USD_H - aws_host_usd_per_hour(8)


def usd_per_hour(host_usd_h: float, accel_usd_h: float,
                 replicas: float) -> float:
    """$/hour of one host feeding ``replicas`` accelerators (fractional
    replicas = time-weighted mean of an adaptive active set)."""
    return host_usd_h + replicas * accel_usd_h


def usd_per_1k_queries(usd_h: float, qps: float) -> float:
    """Measured steady-state throughput -> cost per 1000 queries (the
    paper's Tables 2–3 comparison, per measured configuration)."""
    if qps <= 0:
        return float("inf")
    return usd_h / (qps * 3.6)        # qps * 3600 queries/h / 1000


@dataclass(frozen=True)
class Deployment:
    name: str
    element: str
    units: int
    unit_cost_usd: float          # purchase (on-prem) or $/h (cloud)
    cloud: bool = False
    vcpus: int = 0

    @property
    def total_usd(self) -> float:
        if self.cloud:
            return self.units * self.unit_cost_usd * HOURS_PER_YEAR
        return self.units * self.unit_cost_usd


# ---------------------------------------------------------------------------
# Paper Table 2: Domain Explorer + MCT
# ---------------------------------------------------------------------------

# constants from the paper
_SERVERS = 400                    # CPU-only servers needed for current load
_MCT_CPU_SHARE = 0.40             # MCT share of Domain-Explorer compute
_FPGA_SERVERS = 244               # 400 * (1 - 0.40) rounded up by the paper
_AWS_RATIO = 48 / 8               # c5.12xlarge vCPUs / f1.2xlarge vCPUs
_AZ_RATIO = 48 / 10


def table2() -> List[Deployment]:
    return [
        Deployment("On-Premises / Original Domain Explorer", "CPU",
                   _SERVERS, 10_000, vcpus=48),
        Deployment("On-Premises / DE + ERBIUM (Alveo U200)",
                   "CPU + Alveo U200", _FPGA_SERVERS, 20_000, vcpus=48),
        Deployment("On-Premises / DE + ERBIUM (Alveo U50)",
                   "CPU + Alveo U50", _FPGA_SERVERS, 13_000, vcpus=48),
        Deployment("AWS / Original Domain Explorer", "c5.12xlarge",
                   _SERVERS, AWS_C5_12XLARGE_USD_H, cloud=True, vcpus=48),
        Deployment("AWS / DE + ERBIUM", "f1.2xlarge",
                   int(_FPGA_SERVERS * _AWS_RATIO), AWS_F1_2XLARGE_USD_H, cloud=True,
                   vcpus=8),
        Deployment("Azure / Original Domain Explorer", "F48s v2",
                   _SERVERS, AZURE_F48SV2_USD_H, cloud=True, vcpus=48),
        Deployment("Azure / DE + ERBIUM", "NP10s",
                   int(round(_FPGA_SERVERS * _AZ_RATIO)), AZURE_NP10S_USD_H, cloud=True,
                   vcpus=10),
    ]


def table3() -> List[Deployment]:
    """Table 3: + Route Scoring (80 extra CPU servers on the baseline;
    the FPGA deployment absorbs Route Scoring on the same boards)."""
    return [
        Deployment("On-Premises / Original DE + Route Scoring", "CPU",
                   _SERVERS + 80, 10_000, vcpus=48),
        Deployment("On-Premises / DE + ERBIUM + RS (U200)",
                   "CPU + Alveo U200", _FPGA_SERVERS, 20_000, vcpus=48),
        Deployment("On-Premises / DE + ERBIUM + RS (U50)",
                   "CPU + Alveo U50", _FPGA_SERVERS, 13_000, vcpus=48),
        Deployment("AWS / Original DE + Route Scoring", "c5.12xlarge",
                   _SERVERS + 80, AWS_C5_12XLARGE_USD_H, cloud=True, vcpus=48),
        Deployment("AWS / DE + ERBIUM + RS", "f1.2xlarge",
                   int(_FPGA_SERVERS * _AWS_RATIO), AWS_F1_2XLARGE_USD_H, cloud=True,
                   vcpus=8),
        Deployment("Azure / Original DE + Route Scoring", "F48s v2",
                   _SERVERS + 80, AZURE_F48SV2_USD_H, cloud=True, vcpus=48),
        Deployment("Azure / DE + ERBIUM + RS", "NP10s",
                   int(round(_FPGA_SERVERS * _AZ_RATIO)), AZURE_NP10S_USD_H, cloud=True,
                   vcpus=10),
    ]


# paper-reported totals for validation (USD; cloud = per year)
PAPER_TABLE2_TOTALS = {
    "On-Premises / Original Domain Explorer": 4.0e6,
    "On-Premises / DE + ERBIUM (Alveo U200)": 4.88e6,
    "On-Premises / DE + ERBIUM (Alveo U50)": 3.17e6,
    "AWS / Original Domain Explorer": 5.0e6,
    "AWS / DE + ERBIUM": 15.7e6,
    "Azure / Original Domain Explorer": 4.2e6,
    "Azure / DE + ERBIUM": 10.6e6,
}


# ---------------------------------------------------------------------------
# H100 re-parameterisation (the same imbalance analysis on the port's card)
# ---------------------------------------------------------------------------

# AWS EC2 on-demand pricing page, p5.48xlarge (8x NVIDIA H100 80GB, 192
# vCPUs), us-east-1, at its launch in July 2023: $98.32/hour.
AWS_P5_48XLARGE_USD_H = 98.32
AWS_P5_48XLARGE_GPUS = 8
AWS_P5_48XLARGE_VCPUS = 192


@dataclass(frozen=True, kw_only=True)
class H100CostParams:
    # host-side query-generation capacity (queries/s per vCPU) and card
    # capacity (queries/s per GPU): both measured on the card's machine,
    # no default
    host_qps_per_vcpu: float
    accel_qps_per_chip: float
    gpu_usd_per_hour: float = AWS_P5_48XLARGE_USD_H / AWS_P5_48XLARGE_GPUS
    host_vcpus_per_gpu: float = AWS_P5_48XLARGE_VCPUS / AWS_P5_48XLARGE_GPUS
    # the paper's CPU-only anchor, c5.12xlarge
    cpu_only_usd_per_48vcpu_hour: float = AWS_C5_12XLARGE_USD_H


def h100_balance(params: H100CostParams, target_qps: float
                 ) -> Dict[str, float]:
    """How many GPUs vs how many vCPUs the workload actually needs, and the
    utilisation the platform's fixed vCPU:GPU ratio forces."""
    chips_needed = target_qps / params.accel_qps_per_chip
    vcpus_needed = target_qps / params.host_qps_per_vcpu
    # the platform couples vcpus to GPUs:
    chips_bought = max(chips_needed, vcpus_needed / params.host_vcpus_per_gpu)
    util = chips_needed / chips_bought
    cost_acc = chips_bought * params.gpu_usd_per_hour * HOURS_PER_YEAR
    cost_cpu_only = (target_qps / (params.host_qps_per_vcpu * 48 * 0.6)
                     ) * params.cpu_only_usd_per_48vcpu_hour * HOURS_PER_YEAR
    return {
        "chips_needed": chips_needed,
        "vcpus_needed": vcpus_needed,
        "chips_bought": chips_bought,
        "accel_utilisation": util,
        "accel_cost_usd_year": cost_acc,
        "cpu_only_cost_usd_year": cost_cpu_only,
        "cost_ratio_accel_vs_cpu": cost_acc / max(cost_cpu_only, 1e-9),
    }
