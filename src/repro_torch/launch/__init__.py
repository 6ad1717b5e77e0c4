"""repro_torch.launch — command-line entry points of the port.

``python -m repro_torch.launch.svd_serve`` drives the SVD service
(:mod:`repro_torch.serve`) with a synthetic open-loop request stream.
"""
