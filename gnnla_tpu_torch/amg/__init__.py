"""Host-side AMG setup: splitting, interpolation, Galerkin product."""
