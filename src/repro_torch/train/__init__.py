from repro_torch.train.objectives import lpt_loss, token_cross_entropy

__all__ = ["lpt_loss", "token_cross_entropy"]
