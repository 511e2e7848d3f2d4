"""Deployable artifacts: compile-once export with validated cold start.

The reference's deployment tier (``save_inference_model`` →
``AnalysisPredictor``) re-runs analysis in every serving process; this
subsystem freezes the expensive half ONCE — verified + optimized
program, params, tuned-winner slice, memory prediction, AOT
executables — into one checksummed file, and a serving process
rehydrates it as a file read: zero trace, zero optimize, zero tune,
and (with the AOT section) zero compile. ``ReplicaRouter.roll`` closes
the fleet loop: replicas replace one at a time with drain, zero
stranded requests. See docs/DEPLOYMENT.md.
"""

from __future__ import annotations

from .artifact import LoadedArtifact, load_artifact, save_artifact
from .format import (FORMAT_VERSION, SECTIONS, ArtifactError,
                     ArtifactSkewError)

__all__ = ["save_artifact", "load_artifact", "LoadedArtifact",
           "ArtifactError", "ArtifactSkewError", "FORMAT_VERSION",
           "SECTIONS"]
