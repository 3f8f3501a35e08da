"""Import all assigned architecture configs (one module each)."""
from repro_torch.configs.whisper_tiny import config as whisper_tiny
from repro_torch.configs.starcoder2_7b import config as starcoder2_7b
from repro_torch.configs.llama3_405b import config as llama3_405b
from repro_torch.configs.granite_8b import config as granite_8b
from repro_torch.configs.gemma_7b import config as gemma_7b
from repro_torch.configs.mixtral_8x22b import config as mixtral_8x22b
from repro_torch.configs.dbrx_132b import config as dbrx_132b
from repro_torch.configs.llava_next_mistral_7b import config as llava_next_mistral_7b
from repro_torch.configs.mamba2_1p3b import config as mamba2_1p3b
from repro_torch.configs.hymba_1p5b import config as hymba_1p5b

ALL = [whisper_tiny, starcoder2_7b, llama3_405b, granite_8b, gemma_7b, mixtral_8x22b, dbrx_132b, llava_next_mistral_7b, mamba2_1p3b, hymba_1p5b]
