"""Producers of the port's data: the seismic wavefield (the paper's §4
dataset class), made on the card, and the synthetic LM corpus training
reads."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: F401
                                      batch_to_device, device_put_batch)
from repro_torch.data.seismic import SeismicConfig, SeismicField  # noqa: F401
