"""Bad fixture (under core/): code that turns TF32 on."""
import torch


def fast_matmuls(on=True):
    torch.backends.cuda.matmul.allow_tf32 = True  # BAD
    torch.backends.cudnn.allow_tf32 = on  # BAD: not spelled False
    torch.set_float32_matmul_precision("high")  # BAD: TF32 allowed
