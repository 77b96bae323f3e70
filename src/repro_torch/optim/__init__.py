# AdamW (bf16 parameters, f32 master and moments) and int8 error-feedback gradient compression.
