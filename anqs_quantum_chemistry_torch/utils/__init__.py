from .config import Config
