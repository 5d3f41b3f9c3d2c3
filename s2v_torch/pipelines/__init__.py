"""End-to-end pipelines of the port: ``S2VPipeline`` (``pipelines.s2v``) and
its variants (``pipelines.variants``), exported here as the JAX package
exports them."""

from s2v_torch.pipelines.variants import (  # noqa: F401
    generate_fun_control,
    generate_i2v,
    generate_t2v,
    generate_v2v,
)
