"""AdamW (``adamw``) and int8 error-feedback gradient compression
(``compression``)."""
