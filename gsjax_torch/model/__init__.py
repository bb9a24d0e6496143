from gsjax_torch.model.gaussians import GaussianAux, GaussianParams  # noqa: F401
