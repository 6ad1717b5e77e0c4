"""Training of the port: the train step (ZoloMuon inside) and the loop."""

from repro_torch.train.loop import TrainLoop
from repro_torch.train.step import TrainState, chunked_ce_loss, \
    make_train_step
