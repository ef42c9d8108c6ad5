"""The benchmark's general code: manifest lookup, inputs and weights from
the seed, the serving and training drivers, the trace reader and the
frozen arithmetic the per-layer metrics read."""
