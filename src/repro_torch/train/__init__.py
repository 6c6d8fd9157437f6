from repro_torch.train.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from repro_torch.train.objectives import (chunked_token_cross_entropy, lpt_loss,
                                          lpt_loss_chunked, token_cross_entropy)
from repro_torch.train.optimizer import (OptState, Optimizer, adam, apply_updates,
                                         cosine_schedule, make_optimizer, sgd)
from repro_torch.train.pretrain import (DEFAULT_STEPS, PretrainResult, load_pretrain,
                                        make_pretrain_step, pretrain, testbed_config)

__all__ = ["DEFAULT_STEPS", "OptState", "Optimizer", "PretrainResult", "adam", "apply_updates",
           "checkpoint_exists", "chunked_token_cross_entropy", "cosine_schedule",
           "load_checkpoint", "load_pretrain", "lpt_loss", "lpt_loss_chunked",
           "make_optimizer", "make_pretrain_step", "pretrain", "save_checkpoint", "sgd",
           "testbed_config", "token_cross_entropy"]
