"""The port's execution engine: so far the serving step and the
continuous-batching host loop."""
