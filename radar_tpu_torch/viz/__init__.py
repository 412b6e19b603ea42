"""Port of ``radar_tpu/viz/``: the figures, drawn with matplotlib, which
``plots`` imports only when a function draws."""
from .plots import (plot_beam_patterns_fig, plot_cluster_comparison,
                    plot_pc_profile, plot_ppi, plot_rdm, plot_rhi,
                    plot_smoothed_tracks, plot_snr_sweep, plot_track_history)
