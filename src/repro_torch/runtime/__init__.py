"""Runtime support: straggler detection, the serving slot scheduler and
the prefill/serve step factories."""
