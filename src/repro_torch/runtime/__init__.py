"""Runtime support: straggler detection, the serving slot scheduler, the
train/prefill/serve step factories, chaos injection and the assimilation
engine's elastic resume."""
