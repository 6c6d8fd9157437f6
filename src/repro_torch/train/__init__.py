from repro_torch.train.objectives import (chunked_token_cross_entropy, lpt_loss,
                                          lpt_loss_chunked, token_cross_entropy)
from repro_torch.train.optimizer import (OptState, Optimizer, adam, apply_updates,
                                         cosine_schedule, make_optimizer, sgd)

__all__ = ["OptState", "Optimizer", "adam", "apply_updates", "chunked_token_cross_entropy",
           "cosine_schedule", "lpt_loss", "lpt_loss_chunked", "make_optimizer", "sgd",
           "token_cross_entropy"]
