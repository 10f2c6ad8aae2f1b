from .mesh import (make_group, encode_fields_sharded,  # noqa: F401
                   decode_fields_sharded, encode_field_divided,
                   decode_field_divided, united_encode_step)
