from .codec import decode_field, encode_field, state_from_numpy  # noqa: F401
