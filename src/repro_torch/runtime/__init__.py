"""Runtime support: straggler detection, the serving slot scheduler, the
train/prefill/serve step factories, chaos injection, the assimilation
engine's elastic resume, and the process meshes of the distributed
solve."""
