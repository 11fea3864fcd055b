"""Plotting suite of the port: read-only consumers of the pipeline artifacts
(observables.h5, emulation*.pkl, mcmc.h5), carried over from
``bayesian_inference_tpu.plots`` with the same files, figures and return
values. Host matplotlib; the plots that predict take ``device=`` for the
emulator predictions. Reference modules: plot_input_data, plot_emulation,
plot_mcmc, plot_qhat, plot_closure, plot_analyses."""

from bayesian_inference_tpu_torch.plots import analyses, closure, emulation, input_data, mcmc, qhat

__all__ = ["analyses", "closure", "emulation", "input_data", "mcmc", "qhat"]
