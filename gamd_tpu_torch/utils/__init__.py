from gamd_tpu_torch.utils.profiling import profile_trace, Timer

__all__ = ["profile_trace", "Timer"]
