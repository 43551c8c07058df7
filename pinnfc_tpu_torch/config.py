"""Typed configuration (counterpart of ``pinnfc_tpu/config.py``).

The model and training configs (``train_config_from_dict`` accepts the whole
checkpoint sidecar, schedule included), the AUC and GMM diagnosis configs
(scripts 02 and 03), the six-method comparison's (script 05), and the risk
function's config with its evaluation conditions and fault classes (script
04).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DNN architecture (reference 01:2139-2141)."""

    layers: Tuple[int, ...] = (8, 256, 256, 256, 1)
    dropout_p: float = 0.2
    logvar: bool = True
    precision: str = "highest"
    rng_impl: str = "rbg"


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """One stage of the freeze/unfreeze schedule (reference 01:2143-2153)."""

    name: str
    n_iter: int
    lr: float
    lr_step: int = 1000
    lr_gamma: float = 0.8
    dnn_para: bool = False


def default_schedule() -> Tuple[StageConfig, ...]:
    """The reference training schedule (01:2143-2153)."""
    return (
        StageConfig("dnn", 4001, lr=0.01, lr_gamma=0.8),
        StageConfig("lambda_v", 4001, lr=1e-3, lr_gamma=0.8, dnn_para=False),
        StageConfig("lambda_v", 4001, lr=1e-3, lr_gamma=0.8, dnn_para=True),
        StageConfig("dnn", 8001, lr=0.01, lr_gamma=0.8),
        StageConfig("thermal", 10001, lr=1.0, lr_gamma=0.8),
        StageConfig("hydrogen", 8001, lr=1e-1, lr_gamma=0.9),
        StageConfig("oxygen", 8001, lr=1e-2, lr_gamma=0.9),
    )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """End-to-end configuration of pipeline stage 01."""

    model: ModelConfig = ModelConfig()
    schedule: Tuple[StageConfig, ...] = dataclasses.field(
        default_factory=default_schedule
    )
    training_rate: float = 1.0  # fraction of normal rows used as train (01:2132)
    seed: int = 42
    # MC-dropout export settings (01:2156-2158)
    mc_times: int = 2000
    mc_dropout: float = 0.4
    smooth_window: int = 200  # uncertainty smoothing window (01:1972)
    log_every: int = 1000
    skip_nonfinite: bool = False


def train_config_to_dict(cfg: TrainConfig) -> Dict:
    """JSON-serializable view of a ``TrainConfig`` (checkpoint metadata)."""
    return dataclasses.asdict(cfg)


def train_config_from_dict(d: Dict) -> TrainConfig:
    """Inverse of ``train_config_to_dict`` (tolerates JSON's tuple→list)."""
    model = ModelConfig(**{**d["model"], "layers": tuple(d["model"]["layers"])})
    schedule = tuple(StageConfig(**s) for s in d["schedule"])
    rest = {k: v for k, v in d.items() if k not in ("model", "schedule")}
    return TrainConfig(model=model, schedule=schedule, **rest)


@dataclasses.dataclass(frozen=True)
class AucConfig:
    """Supervised / unsupervised AUC evaluation (script 02 constants)."""

    feature_groups: Tuple[str, ...] = ("epi,res", "x0,x3,x4,x5", "res", "y_true")
    plot_features: str = "x0,x3,x4,x5"  # scatter/t-SNE view features (02:51)
    group_spec: str = "正常:0 | 故障:1,2,3,4,5,6,7,8,9,10,11,12"  # 02:55
    test_size: float = 0.9  # 02:57
    random_state: int = 49  # 02:58
    balanced: bool = True  # 02:59
    iso_n_estimators: int = 200  # 02:584
    iso_max_samples: int = 256
    # 'device' = the batched torch forest (diagnosis/isoforest.py);
    # 'sklearn' = the reference's CPU estimator (02:583-596)
    iso_backend: str = "device"


@dataclasses.dataclass(frozen=True)
class GmmConfig:
    """Unsupervised GMM diagnosis (script 03 constants)."""

    group_spec: str = "水淹:1,2,3|氧饥饿:4,5,6|膜干:7,8,9|氢饥饿:10,11,12"  # 03:28
    features: str = "pV,pT,pH,pO"  # 03:29
    test_size: float = 0.25  # 03:30
    random_state: int = 42  # 03:31
    n_components_factor: int = 5  # 03:548
    covariance_type: str = "full"  # 03:386
    max_iter: int = 100
    tol: float = 1e-3
    reg_covar: float = 1e-6
    # EM initialization: 'kmeans' = the port's k-means++ (default);
    # 'sklearn' = sklearn GaussianMixture's own kmeans init responsibilities
    # (one CPU k-means; needs scikit-learn)
    init: str = "kmeans"
    # EM arithmetic: 'float32' or 'float64'
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class CompareConfig:
    """Six-method comparison (script 05)."""

    n_classes: int = 4
    test_size: float = 0.25  # via 03:30
    random_state: int = 42
    gmm_components_factor: int = 5  # 05:644
    kmeans_clusters_factor: int = 5  # 05:654
    agglo_clusters_factor: int = 4  # 05:661
    spectral_clusters_factor: int = 4  # 05:669
    svm_c: float = 0.05  # 05:330
    spectral_n_neighbors: int = 10  # 05:477


@dataclasses.dataclass(frozen=True)
class RiskConfig:
    """RF(t) risk-function configuration (script 04:82-164)."""

    res_keys: Tuple[str, ...] = ("res", "pV", "pT", "pH", "pO")  # 04:88
    layer_config: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
        ("voltage", ("res", "pV")),
        ("gas", ("pH", "pO")),
        ("temp", ("pT",)),
    )  # 04:92-96
    feature_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)  # 04:99
    layer_weights: Tuple[Tuple[str, float], ...] = (
        ("voltage", 1.0),
        ("gas", 1.0),
        ("temp", 1.0),
    )  # 04:102-106
    p_layer: float = 2.0  # 04:109
    z_safe: float = 2.0  # 04:112
    lambda_decay: float = 0.9971  # 04:115
    k_logistic: float = 0.0005  # 04:118
    c0_logistic: float = 500.0  # 04:119
    c_max: float = 1000.0  # 04:120
    alpha_smooth: float = 0.2  # 04:130
    current_tol: float = 0.5  # 04:133
    warn_threshold: float = 0.3  # 04:163
    danger_threshold: float = 0.6  # 04:164
    voltage_drop: float = 0.1  # dynamic threshold = V(0) - 0.1 V (04:389)
    normal_labels: Tuple[int, ...] = (0,)  # 04:85


def risk_config_from_dict(d: Dict) -> RiskConfig:
    """Inverse of ``dataclasses.asdict(RiskConfig())`` after a JSON round
    trip (JSON turns every tuple into a list): the risk config an
    ``export-model --monitor-step`` sidecar recorded as baked."""
    rebuild = {
        "res_keys": lambda v: tuple(v),
        "layer_config": lambda v: tuple((name, tuple(keys)) for name, keys in v),
        "feature_weights": lambda v: tuple(float(w) for w in v),
        "layer_weights": lambda v: tuple((name, float(w)) for name, w in v),
        "normal_labels": lambda v: tuple(int(x) for x in v),
    }
    # every other field passes through as it is, read off the dataclass so a
    # later field is never dropped back to its default
    return RiskConfig(**{f.name: rebuild.get(f.name, lambda v: v)(d[f.name])
                         for f in dataclasses.fields(RiskConfig) if f.name in d})


# The 12 (current, fault, relative index range) evaluation conditions
# (reference 04:145-161).
DEFAULT_RF_CONDITIONS: Tuple[Tuple[float, str, Optional[Tuple[int, Optional[int]]]], ...] = (
    (108.0, "水淹", (0, 1050)),
    (108.0, "氧饥饿", None),
    (108.0, "膜干", None),
    (108.0, "氢饥饿", None),
    (270.0, "水淹", None),
    (270.0, "膜干", None),
    (270.0, "氧饥饿", None),
    (270.0, "氢饥饿", None),
    (405.0, "水淹", None),
    (405.0, "氧饥饿", None),
    (405.0, "膜干", None),
    (405.0, "氢饥饿", None),
)

# Fault-class label ranges (04:75-80): detail labels 1-12 → 4 coarse classes.
FAULT_RANGE_MAP: Dict[str, range] = {
    "水淹": range(1, 4),
    "氧饥饿": range(4, 7),
    "膜干": range(7, 10),
    "氢饥饿": range(10, 13),
}

# English names of the four fault classes, for figures and saliency tables.
FAULT_NAMES_EN: Dict[str, str] = {
    "水淹": "Flooding",
    "氧饥饿": "Oxygen starvation",
    "膜干": "Membrane drying",
    "氢饥饿": "Hydrogen starvation",
}
