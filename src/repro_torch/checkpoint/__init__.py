from .io import (expert_nbytes, list_experts, load_expert,
                 load_expert_meta, load_pytree, save_expert, save_pytree)

__all__ = ["save_pytree", "load_pytree", "save_expert", "load_expert",
           "load_expert_meta", "list_experts", "expert_nbytes"]
