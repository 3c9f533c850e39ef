from .dist import (barrier, broadcast_state, check_mesh_shape, gather_rows,  # noqa: F401
                   init_distributed, is_main, rank, shutdown, world)
