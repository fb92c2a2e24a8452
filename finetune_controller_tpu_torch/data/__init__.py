"""Host-side data pipeline of the training path (copies of the reference's
``data/`` loaders, which import no JAX)."""
