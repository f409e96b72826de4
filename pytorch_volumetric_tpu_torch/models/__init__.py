from pytorch_volumetric_tpu_torch.models.neural_sdf import (
    NeuralSDF, ConfigSpaceNeuralSDF, fit_neural_sdf, fit_config_space_sdf,
    mlp_init, mlp_forward, fourier_features, MLP,
)
