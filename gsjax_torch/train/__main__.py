"""`python -m gsjax_torch.train ...`: the training CLI (`gsjax_torch.train.main`)."""

from gsjax_torch.train import main

main()
