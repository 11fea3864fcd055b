"""GP emulators: PCA, GP regression and the batched hyperparameter fit."""
