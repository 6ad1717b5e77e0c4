"""repro_torch.launch — command-line entry points of the port.

``python -m repro_torch.launch.svd_serve`` drives the SVD service
(:mod:`repro_torch.serve`) with a synthetic open-loop request stream;
``python -m repro_torch.launch.train`` trains an architecture of the
registry with ZoloMuon; ``python -m repro_torch.launch.serve`` generates
from one with the LM ``ServeEngine``.
"""
