"""Run inference with a Zeiss .czann model (the JAX package's
``plugins/czann_inference.py``). Requires the optional ``czmodel``
package; errors clearly when absent, and, as in the JAX package, also
when present."""


def execute(chunk, model_file: str = None):
    try:
        from czmodel.pytorch.convert import DefaultConverter  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "czann_inference needs the 'czmodel' package, which is not "
            "installed in this environment"
        ) from e
    raise NotImplementedError(
        "czann support requires the czmodel runtime; load the extracted "
        "model with the 'universal' inference engine instead"
    )
