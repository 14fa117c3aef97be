"""The harness's general pieces: manifest, environment, spans, profiling,
seeded inputs and the result line."""
