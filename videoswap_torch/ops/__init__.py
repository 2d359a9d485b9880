from .attention import attention_with_probs, dot_product_attention

__all__ = ['dot_product_attention', 'attention_with_probs']
