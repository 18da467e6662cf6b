"""Producers of the port's in-transit data: the seismic wavefield (the
paper's §4 dataset class), made on the card."""
from repro_torch.data.seismic import SeismicConfig, SeismicField  # noqa: F401
