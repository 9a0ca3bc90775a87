from scale_letkf_tpu.cli.main import main
from scale_letkf_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
main()
