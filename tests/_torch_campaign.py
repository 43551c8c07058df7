"""The miniature measurement campaign that the port's campaign, resume and
report tests share (imported by ``tests/test_torch_{campaign,resume,reports}.py``).

The synthetic generator's arrays (100 normal rows before the 50 < I < 800
filter, 12 fault segments of 10 rows, seed 42) are written to disk by the JAX
package's ``write_campaign_mats`` twice, once with ASCII file names and once
with the reference's Chinese ones, and loaded back through the port.
"""

import types

import pytest
import torch

from pinnfc_tpu.data.campaign import write_campaign_mats as jax_write_campaign_mats
from pinnfc_tpu_torch.data.campaign import CampaignConfig, load_campaign_dataset
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.models.pinn import init_pinn

N_NORMAL, N_FAULT, SEED = 100, 10, 42


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """Namespace: ``normal``/``faults`` (the arrays), ``ascii_dir``/``zh_dir``
    (the two campaign directories), ``config`` (the ASCII campaign's port
    ``CampaignConfig``), ``ds`` (its port dataset on the CPU) and ``params()``
    (fresh port params from ``torch.Generator().manual_seed(1)``)."""
    normal, faults = synthesize_stack_data(n_normal=N_NORMAL, n_fault=N_FAULT, seed=SEED)
    root = tmp_path_factory.mktemp("campaign")
    ascii_dir, zh_dir = str(root / "ascii"), str(root / "zh")
    jax_write_campaign_mats(ascii_dir, normal, faults)
    jax_write_campaign_mats(zh_dir, normal, faults, ascii_names=False)
    config = CampaignConfig.from_dir(f"{ascii_dir}/Polar-1.mat", ascii_dir)
    return types.SimpleNamespace(
        normal=normal, faults=faults, ascii_dir=ascii_dir, zh_dir=zh_dir, config=config,
        ds=load_campaign_dataset(config, device="cpu"),
        params=lambda: init_pinn(generator=torch.Generator().manual_seed(1), device="cpu"),
    )
